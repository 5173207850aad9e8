#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--seed S]

Phases, one or more printed lines each:
  1. card     nvidia-smi's name and power limit, torch and CUDA versions;
  2. build    nvcc builds mimo_tpu_torch/csrc/*.cu into build/ (one nvcc
              per source, all started together), then the S3 probe
              (o = 2 x) must equal 2 x exactly;
  3. B1       the fused E-step kernel against its plain PyTorch version at
              N=1,000,003, K=50, d=2 (and d=3, K=7, N=1000), run twice
              and required bitwise equal;
  4. B2       the Gibbs label-sweep kernel: labels in range, statistics
              equal to the one-hot sums of its own labels, labels equal to
              the plain Philox draw for draw, label frequencies at 4 points
              within 5 sigma of the softmax, the fast Gumbel draw within
              2^-12 of float64 over all 2^23 uniforms; then B1 and B2
              in the streamed layout (K=300, d=2, N=1,000,003) against
              their plain versions, timed;
  5. B3       the predictive-density kernel against its plain version,
              Student-t and Gaussian;
  6. main     the DP-GMM main path at N=1e7, K=50, d=2 through the
              public entry points (fit_vi_fused, fit_gibbs_fused,
              log_predictive), with the kernels' launch counts and the
              K-sized algebra's counts of the VI and the Gibbs fit
              (Choleskys, solves, prior constants built and read; printed,
              not checked), a kernel-vs-plain check of the engines on a 100,003-point slice, the
              rates, each kernel's time beside its plain version's, and
              B1's precision line: its lse and statistics against float64
              beside the f32 plain version's (at most 10x); B3's Gaussian
              variant at the VI state (log_predictive(dist='gaussian'),
              one launch) against its plain version and the one PyTorch
              call of the same function, MixtureSameFamily over
              MultivariateNormal, timed;
  7. ILR      B1 and B2 over the ILR feature map at N=1,000,003, K=50,
              d=8, p=1 (and d=2, p=3, K=7, N=1000): B1 bitwise repeatable,
              B2 labels equal to the plain Philox labels; B5 (p=1, d=1)
              and B6 (p=3, d=2) at N=1,000,003, K=50 against their plain
              versions, average and mode, with and without y;
  8. ILR fit  the q8 fit path (N=1e6, K=50, d=8, p=1): fit_gibbs_fused
              then fit_vi_fused warm-started from it, 20 sweeps each
              through B1/B2 over the ILR map, launch counts, a finite
              non-falling ELBO, kernel vs plain on a 100,003-point slice,
              rates, B1's precision line at m8=168;
  9. serving  the sine flagship (N=1e7, d=1, p=1: Gibbs 10 -> VI 20 ->
              predict through B5, RMSE and NLPD) and p>1 serving (N=1e6,
              d=2, p=3: VI 20 -> predict through B6), rates, and each new
              kernel's time beside its plain version's;
 10. diag     B1 and B2 over the diagonal map [1; x; x^2] at N=1,000,003,
              K=50, d=2 (and d=3, K=7, N=1000), B1 bitwise repeatable, B2
              labels equal to the plain Philox labels; B3 over the
              diagonal map (Gaussian) and B4 (Student-t) at N=1,000,003,
              K=50, d=2; B5 with MNG experts (d=1, p=1) and B6 with its
              MNG tail (d=2, p=3), average and mode, with and without y;
 11. diag GMM the diagonal GMM of bench.py:168-188 (N=1e7, K=50, d=2, NG,
              Dirichlet gating, kappa=0.05): fit_vi_fused 20,
              fit_gibbs_fused 20, log_predictive Student-t (B4) and
              Gaussian (B3-diag), launch counts, ELBO, kernel vs plain on
              a 100,003-point slice, rates, kernel times and B1's precision
              line over the diagonal map;
 12. MNG      the sine flagship with MNG experts (N=1e7, d=1, p=1: Gibbs 10
              -> VI 20 -> predict through B5's MNG rows) and p>1 MNG
              serving (N=1e6, d=2, p=3: VI 20 -> predict through B6's MNG
              tail), rates and kernel times;
 13. branches B3 on HierTied rows (Student-t and Gaussian, d=2), B5 (d=1,
              p=1) and B6 (d=2, p=3) on every new basis x expert
              combination ({NIW, HierTied} x {MNW, MNG, tied-affine}), at
              N=1,000,003, K=50, average and mode, with and without y; the
              B1 probes S1 (divide and no divide) and S2 (no count, an
              unread and a read count in device memory) against their
              plain versions at N=1e7, K=50, d=2 (S2 also at the TPU
              probe's K=8, d=2, N=4096, nv=4000), then timed beside B1;
 14. tied     the tied GMM, the tied diagonal GMM and the hierarchical GMM
              on the data of bench.py:90-98 (N=1e7, K=50, d=2):
              fit_vi_fused 20, fit_gibbs_fused 20, log_predictive (B3 on
              HierTied rows for the hierarchical GMM), launch counts,
              the hierarchical update's inner rounds and Choleskys, ELBO,
              kernel vs plain on a 100,003-point slice, rates and kernel
              times;
 15. hilr     the tied-activation ILR (HierTied basis x tied-affine
              experts): the sine flagship (N=1e7, d=1, p=1: Gibbs 60 over
              the first 10,000 points -> VI 20 over all -> predict through
              B5, RMSE < 0.35) and p>1 serving
              (N=1e6, d=2, p=3: VI 20 -> predict through B6), rates and
              kernel times;
 16. wide     the serving kernels at shapes they refused before their
              coefficients were streamed in K-chunks (B3 at K=500, d=2, a
              DP-GMM after 3 VI sweeps, K=256, d=8 and K=16, d=24; B4 at
              K=64, d=32; B5 at K=194 and 500, d=8; B6 at K=300, d=2, p=3,
              MNW and MNG), N=1,000,003: each served once through
              log_predictive or predict with launch counts, held against
              its plain version and timed.
 17. engines  MAP-EM and ML-EM through B1 with plug-in theta: the DP-GMM
              of phase 6 (N=1e7, K=50, d=2) by fit_map_fused 50 and
              fit_em_fused 50, B1 launched exactly once a sweep, finite
              traces (EM's not falling beyond 1e-4 relative f32 jitter),
              kernel vs plain on a 100,003-point slice, rates, B1's time
              at each fit's final theta, and B1 against its plain version
              on that slice and its precision line at each final theta
              and at the MAP theta given the ML-EM fit (MAP from its
              random start stays near the symmetric point); the q8 ILR
              fit (N=1e6, d=8) by fit_map_fused 20 and fit_em_fused 20
              through B1 over the ILR map, the same checks; the dense
              engines on the first 1e6 points of phase 6's data (fit_vi,
              fit_map, fit_em, fit_gibbs and GMM.fit_em, 20 sweeps each:
              finite traces, rates, no kernel launched); SVI over all 1e7
              points (step 0.5, 500 steps at B=256 and 200 at B=65536:
              finite states, steps/s from the random init and warm).
 18. nested   the nested mixtures of mixtures (BayesianMixtureOfMixtures),
              whose fused engines and serving flatten the (M, K) posterior
              to M*K kernel rows: the nested GMM of bench.py:358-383 (N=1e6,
              two blobs, M=4, K=8, d=2) by fit_vi_fused 50 (B1 exactly 50
              launches), fit_gibbs_fused 50 (B2 50) and log_predictive (B3
              once), and the same hierarchical (20 sweeps each, the exact
              draws, B3 on HierTied rows built per cluster, checked
              against the dense density in float64); nested MAP-EM and
              ML-EM at N=1e7 (bench.py:385-398) by fit_map_fused 20 and
              fit_em_fused 20, with phase 17's checks and their peak
              device memory; B2 at each final Gibbs theta against its
              plain version (labels equal to the plain Philox labels,
              statistics equal to its own labels' one-hot sums) and
              fit_gibbs_fused 3 sweeps kernel vs plain; nested ILR
              serving (bench.py:400-420: the sine at N=1e7, M=2, K=6, dense
              fit_gibbs on the first 2e5, predict through B5, RMSE < 0.25) and
              fused VI 20 over the first 1e6 through B1's ILR map at
              M*K=12; p=2 serving (tests/test_pallas.py:474-499: N=1e6,
              M=2, K=4, dense fit_vi on the first 1e5, predict through B6);
              each with kernel vs plain on 100,003 points, B1's precision
              line at every final theta, the serving kernels' float64
              lines, rates and kernel times; and the dense nested engines
              (fit_vi, fit_map, fit_em, fit_gibbs 10 each, fit_svi 100 at
              B=256) on the first 1e5 points with no kernel launched.
 19. chains   multi-chain inference (parallel/chains.py) through B1 and B2
              with a chain axis: phase 6's DP-GMM (N=1e7, K=50, d=2) by
              fit_chains over 8 keys, fit_vi_fused 20 (B1 exactly 20
              launches for all 8 chains), fit_gibbs_fused 20 (B2 20) and
              fit_map_fused 20 (B1 20), best_of, diagnostics on the VI
              traces and log_predictive of the best state (B3 once);
              B1-chain at each chain's final theta bitwise the one-chain
              launch (the same grid along x), at phase 3's tolerances of
              the plain version on
              100,003 points, and each chain's float64 line; B2-chain
              at each chain's theta and seed with 0 labels differing from
              the one-chain launches, within phase 4's bounds of the
              plain version; fit_chains twice with the same keys equal;
              each VI chain within 1e-5 of fit_vi_fused with its key;
              rates of 8 chains against one fit, the aggregate speedup
              and peak memory. Then bench.py:421-439's cell (the first
              1e5 points, K=16, 16 chains of fit_vi_fused 50: B1 50
              launches), the fixed-state two-sample check of B2 (N=1e5,
              K=50, S=256 sweeps of one theta from a fused Gibbs 20 as
              256 chains in one launch, against the exact and the
              precision rule's expectation: max |z| <= 5, chi^2/df <= 2,
              variance ratio in [0.8, 1.25]), B1-chain over the q8 ILR
              map (N=1e6, m8=168, C=4, fit_chains VI 5), B1/B2-chain in
              the streamed layout (K=300, d=2, N=1e6, C=2, VI 3 and Gibbs
              3), and smc_gibbs on examples/chains_smc.py's data (N=1e4,
              K=10, 8 chains, 8 rounds of 10 sweeps: finite, the last
              round's log-likelihood not below the first's); then chains of
              phase 18's nested GMM (N=1e6, M=4, K=8, d=2) by fit_chains
              over 8 keys: fit_vi_fused, fit_gibbs_fused, fit_map_fused and
              fit_em_fused 20 each, B1 / B2 exactly 20 launches for all
              chains, best_of and log_predictive (B3 once), each VI chain
              within 1e-5 of the nested fit with its key, B1-chain and
              B2-chain at M*K=32 rows against their one-chain launches.
              Each chain row is timed beside its C one-chain launches and
              its plain version; its bound is C times the one-chain work.
 20. stream   the out-of-core engines from files in the temp directory
              (written by io.write_bin, read by io.MmapDataset's native
              loader, deleted at the end): fit_svi_stream over the first
              2e6 points of phase 6's data (bench.py:201-233: B=65536, 100
              steps, group 16, float32 and bf16 on the wire, prefetch depth
              1 and 3 bitwise equal); fit_vi_stream_full over them in 4
              blocks of 5e5 (bench.py:235-258: B1 exactly 4 launches a
              sweep, against fit_vi_fused in memory by phase 3's rule);
              phase 6's 1e7 points in blocks of 2^20 (9 blocks and a
              562,816-point tail) from phase 6's VI state: VI 5 against
              the in-memory fit, MAP 5, ML-EM 5 from block 0's anchors
              (traces finite and non-falling; its staged start 3 times
              within 1e-3 of the start formed without the stager), the
              bf16 leg within 1e-4,
              peak device memory below the in-memory fit's, rates; and B1
              at the staged block and the tail against its plain version,
              timed (the B1-stream row, with its launches a sweep).
 21. mesh     first, alone on the card, two processes through gloo
              (parallel.launch: a (1, 4) mesh of two positions each, VI,
              Gibbs and MAP-EM 10 at N=1e6, against the one-process run:
              the first sweep, the first Gibbs labels, the traces, one
              all_reduce of K m8 + 1 floats a sweep at N=1e6 and 5e5, the
              all_reduce's time inside a sweep and alone after a
              barrier); then the device mesh (parallel/mesh.py) in this
              process over four positions on this card, against the
              unsharded engines from the same keys, on phase 6's data
              (N=1e7, K=50, d=2):
              fit_vi_fused 20 (B1 exactly 4 x 20 launches, 20 reductions;
              the trace and state by phase 3's rule, as the streamed
              sweep), one sweep from a shared state (lse and statistics
              within 1e-5), fit_gibbs_fused 1 (shard 0's labels bitwise
              the unsharded sweep's) and 20 (B2 80 launches; each shard's
              statistics the one-hot sums of its labels), fit_map_fused
              20 (B1 80), log_predictive (B3 once a shard, bitwise the
              unsharded launch, no reduction); N=5 on eight positions
              (three empty) through B1, B2 and B3; fit_chains VI 10 over a
              (2, 2) mesh, 4 keys, the first 1e6 points, against the
              unsharded fit_chains; a world-size-1 NCCL group's sweep;
              B4, B5 and B6 over the
              shards of N=1,000,003 random-posterior points, bitwise the
              unsharded launch; a sweep's wall sharded and unsharded, each
              shard's B1 and B2 and the fold; the sharded rows (one
              shard's launch; launches as counted on each path) in the
              kernels line; in the two-process launch, phase 22's leg
              (e).
 22. stream   the out-of-core and dense engines over a (1, 4) mesh of
     + mesh   cuda:0: (a) phase 20's 1e7 points from a file in blocks of
              2^20 (9 and a 562,816-point tail), VI and MAP 5 from phase
              6's VI state against the unsharded streamed fits by phase
              3's rule, ML-EM 5 from a given state (its trace, means and
              weights; its anchor start refused over the mesh, as JAX
              refuses it), bf16 on the wire; B1 exactly 4 launches a
              block (40 a sweep) and one reduction a sweep; peak device
              memory beside the unsharded stream's; (b) phase 20's 2e6-
              point file through fit_svi_stream (B=65536, 100 steps,
              group 16): B1 4 launches and one reduction a step, against
              the same run over one position by its mean log predictive
              and weights; (c) the dense fit_vi, fit_map, fit_em and
              fit_gibbs 20 through data_parallel_fit on the first 1e6
              points (phase 17's cut): traces within rtol 1e-5 of the
              unsharded fits from the same keys (Gibbs: where the mass
              went, the loglik climbing), no kernel, one reduction a
              sweep and the start's; (d) fit_chains dense VI 10 over a
              (2, 2) mesh, 4 keys, against the unsharded fit_chains; (e)
              in phase 21's two-process launch, each process streams its
              own file shard through fit_svi_stream and
              fit_vi_stream_full and runs the dense VI and Gibbs on its
              shards, each against the one-process run, one all_reduce a
              sweep or step. The B1-stream-sharded (262,144 points, a
              column view of the staged block) and B1-svi-stream-sharded
              (16,384 points) rows in the kernels line.
 23. certify  (a) the Geweke test of the full Gibbs transition
              (mimo_tpu_torch.scripts.geweke_gibbs) of all 8 families in
              float32 with the label sweep on B2, n=256, K=3 (nested M=2):
              max|z| < 6.0, no draw dropped, B2 once a transition; the
              B2-geweke row; (b) fit_with_checkpoints on phase 6's DP-GMM,
              fit_vi_fused 20 in chunks of 5: a run stopped at 10 and
              resumed by a fresh call bitwise the whole run, both against
              a straight fit by phase 3's rule, B1 20 launches a run, the
              checkpoint's bytes and save / load times; (c) smc_study at
              its defaults, one seed, B3 once a chain of each arm; (d)
              precision_study at N=1e7, VI 50 and Gibbs 10: the VI
              held-out mean log predictive of the kernels within 1e-3
              nats/point of the plain twins'. Every family's statistics
              include its data moments (3, or 5 for the ILR families).
 24. examples the example drivers (mimo_tpu_torch/examples) through their
              main(argv) on the card: (a) all twelve at their defaults,
              one after another, without --plot: wall seconds, returned
              numbers (all finite; each driver's own checks), B5 launches
              (> 0 for ilr_sine, ilr_eval, ilr_sinc_study and hilr) and
              B1 (> 0 for stream_svi); (b) ilr_eval on sine, sinc, step,
              step_poly, chirp and inverse at seeds 0, 1 and 2 (numpy's
              default_rng data, as JAX draws it), B5 once a run: the 6 x 3
              table of RMSE and mean NLPD beside the frozen thresholds of
              tests/test_examples.py:54-63, seed 0 under both; (c) the
              B5-eval rows: B5 against its plain twin at the sine (N=2000,
              K=50, d=1) and step_poly (N=160, K=10, d=3) fits, timed by
              CUDA events and the profiler's device time.
 25. diag-    B1 and B2 over the ILR map on a diagonal (NG) basis, [1; x;
     basis    x^2; y (x) xa; xa (x) xa; y (x) y] (kinds ILR_DIAG and
              ILR_DIAG_LINEAR), with and without the experts' ones column,
              at N=1,000,003, K=50, d=8, p=1 (m8=112) and N=1e7, d=1, p=1:
              B1 against its plain version (max |err| <= 1e-5 of the
              summed magnitudes, lse rtol 1e-5) and bitwise on repeat, its
              precision line; B2's labels against the plain Philox labels
              and its statistics against its labels' one-hot sums; then
              its fit path (no model class builds the map: a
              BayesianMixture over the NG x MNW product family with that
              spec, N=1e6, d=8): fit_gibbs_fused 10 then fit_vi_fused 10
              from its state, B1 and B2 exactly 10 launches each, kernel vs
              plain on 100,003 points, rates, the B1-ILR-diagbasis and
              B2-ILR-diagbasis rows at the fitted state.
 26. dense    every dense engine batched over C=8 chains by fit_chains
     chains   (fit_vi, fit_map, fit_em 10 sweeps, fit_svi 100 steps at
              B=256) at examples/chains_smc.py's cell (N=1e4, K=10,
              DP-GMM) and at N=1e6, K=16 (phase 6's data), the nested
              fit_vi and fit_em at phase 18's cell (N=1e6, M=4, K=8) and
              the dense ILR fit_vi at the sine's shape (N=1e6, K=50, d=1,
              p=1): each chain's trace within rtol 1e-5 of its serial fit
              with the same key (SVI's full-data ELBO over 20 steps),
              states finite, no kernel launched; the batched and the
              serial seconds, each the median of 3 runs.
 27. fed      B1 and B2 in the streamed layout (csrc/tc.cuh) at bench.py's
              MXU-fed shapes, on bench.py:90-98's data (3 clusters, mu ~
              4 N(0, I), Lambda = 2 I, weights .3/.4/.3; gating 'dp',
              alpha 1, kappa 0.05, psi_scale 0.5): (a) N=1e7, K=128, d=8
              (bench.py:297; the plain layout at width 12), fit_vi_fused
              50 and fit_gibbs_fused 50; (b) N=1e6, K=128, d=16, VI 20,
              Gibbs 20, fit_map_fused 20 and fit_chains VI 5 at C=2; (c)
              N=1e6, K=256, d=32 (bench.py:305), VI 20, Gibbs 5,
              fit_em_fused 5 and log_predictive through B3 (padded width
              32); each with its launch counts (exactly one a sweep), a
              finite VI ELBO that does not fall (1e-4 relative; ML-EM's
              loglik the same), kernel vs plain on 100,003 points, B1 at
              the VI theta: its precision line, bitwise on repeat, lse
              within rtol 1e-5 of its plain version and the statistics
              within 1e-3 of each entry's summed magnitude (phase 3's
              rule printed beside it: at d >= 16 the f32 logits of the
              two versions part by ~1e-3 nats), B3 by its float64 lines
              on 100,003 and all points (the same reason), B2's
              labels against the plain Philox labels and its statistics
              against their one-hot sums, rates, and each kernel's time
              beside its plain version's (rows B1-fed-*, B2-fed-*,
              B3-fed-d32); (d) the ILR map at d=16, p=1, K=50 (m8 = 584),
              N=1,000,003: fit_gibbs_fused 5 then fit_vi_fused 5 from its
              state, its VI kernel vs plain on 100,003 points, B1 and B2
              checked and timed the same way (rows
              B1-fed-ilr16, B2-fed-ilr16).
Phases 6, 9, 11 and 12 also print the serving kernels' float64 precision
lines (B3, B4, B5, B6, B5/B6 with MNG experts): each output row's error
against the plain version run in float64 on the kernel's own f32 inputs,
beside the f32 plain version's error, at the main cell and at an
off-origin cell (data and posterior translated so that every component
centre sits at least 10 sigma from the origin, where the expanded
quadratic cancels); each fails above 10x.
The line before the last is the kernels' JSON record: each kernel's
launches on its path, its time, its plain version's, and its bound (the
least time the card could take for the work, the largest of bytes over
the memory rate and each unit's operations over its peak; `bound_by` says
whether bytes or operations set it, `bound_op` names the unit: hbm,
fp32, tf32, mufu or int); the last line is
{"ok": true, "device": {...}}. Without a CUDA device, or if any check
fails, the script exits non-zero and prints no result.
"""

import argparse
import functools
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
from torch.func import vmap

import mimo_tpu_torch  # noqa: F401  (sets the float32 precision policy)
from mimo_tpu_torch.conjugate.families import (
    diag_gaussian_family, ilr_family, linear_family, product_family)
from mimo_tpu_torch.distributions import hierarchical, ng, niw
from mimo_tpu_torch.distributions.affine import TiedAffine
from mimo_tpu_torch.distributions.gating import Dirichlet, StickBreaking
from mimo_tpu_torch.distributions.hierarchical import HierTied
from mimo_tpu_torch.distributions.mng import MNG
from mimo_tpu_torch.distributions.mnw import MNW
from mimo_tpu_torch.distributions.ng import NG
from mimo_tpu_torch.distributions.niw import (
    GaussParams, GaussStats, NIW, mode_params, predictive_studentt_params)
from mimo_tpu_torch.io import MmapDataset, write_bin
from mimo_tpu_torch.models import (
    GMM, BayesianGMM, BayesianILR, BayesianMixtureOfMixtures)
from mimo_tpu_torch.models.hmix import HMixState, _flatten_mk
from mimo_tpu_torch.models.mixture import (
    BayesianMixture, MFState, _Shards, stack_trees)
from mimo_tpu_torch.ops import (
    _build, cuda_diag_predict, cuda_estep, cuda_gibbs, cuda_hello,
    cuda_ilr_predict, cuda_predict, cuda_probes, precision)
from mimo_tpu_torch.ops.cuda_estep import (
    DIAG, ILR, ILR_DIAG, ILR_DIAG_LINEAR, assemble_features, kernel_xts,
    pad_theta, stack_rows)
from mimo_tpu_torch.ops.family_estep import (
    diag_gaussian_spec, gaussian_spec, ilr_spec)
from mimo_tpu_torch.parallel import (
    best_of, diagnostics, fit_chains, smc_gibbs)
from mimo_tpu_torch.utils import linalg
from mimo_tpu_torch.utils.tree import cast_floats, tree_map2

N_MAIN, K_MAIN, D_MAIN = 10_000_000, 50, 2
N_CHECK = 1_000_003            # a ragged tail for the 128-point tiles
N_Q8, D_Q8 = 1_000_000, 8      # the ILR fit path (bench.py:313-336)
N_SINE = 10_000_000            # ILR serving, sine (bench.py:338-356)
N_P3, D_P3, P_P3 = 1_000_000, 2, 3   # p>1 serving (test_pallas.py:445)
N_HILR_GIBBS = 10_000          # the hilr sine's Gibbs warm start

# Peak rates of one H100 SXM for the kernels' bounds: HBM 3.35 TB/s, f32
# 67 TFLOP/s outside the tensor cores (33.5e12 FMA/s) and dense TF32
# 495 TFLOP/s on them (247.5e12 multiply-adds/s) from NVIDIA's data sheet;
# the MUFU (16 special-function results per clock per SM) and integer (64
# lanes per clock per SM) rates at the 1.98 GHz clock behind the f32
# figure, 132 SMs.
PEAKS = {'hbm': 3.35e12, 'fp32': 33.5e12, 'tf32': 247.5e12,
         'mufu': 16 * 132 * 1.98e9, 'int': 64 * 132 * 1.98e9}
# TF32 passes per multiply-add of B1 and B2's products, the precision rule
# of csrc/estep.cuh: six for the logits theta F, three for B1's
# statistics P F^T
LOGIT_PASSES, STATS_PASSES = 6, 3
WORK = {}    # kernel name -> the work of its timed call, by unit


def fail(msg):
    raise SystemExit(f'chip_smoke: FAIL: {msg}')


def check(cond, msg):
    if not cond:
        fail(msg)


def allclose_report(got, want, rtol, atol):
    """(ok, max |got - want|) under |got - want| <= atol + rtol |want|."""
    err = (got.double() - want.double()).abs()
    ok = bool((err <= atol + rtol * want.double().abs()).all())
    return ok, float(err.max()) if err.numel() else 0.0


def cuda_ms(fn, reps, warm=2):
    """Mean device time of fn() over `reps` runs, by CUDA events, after
    `warm` warm-up runs."""
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_posterior(gen, k, d, dev):
    """A random NIW posterior with the scales of a fit at N ~ 1e6."""
    a = torch.randn((k, d, d), generator=gen, device=dev)
    psi = (a @ a.transpose(-1, -2) / d + torch.eye(d, device=dev)) * 2e-4
    return NIW(mu=torch.randn((k, d), generator=gen, device=dev) * 4.0,
               kappa=1.0 + 1e5 * torch.rand((k,), generator=gen, device=dev),
               psi=psi,
               nu=d + 2.0 + 1e5 * torch.rand((k,), generator=gen, device=dev))


def ptxas_summary(logs):
    """'file.cu kernel<map>: R regs, S B spilled' for each kernel in
    nvcc's -Xptxas -v output, one log per source."""
    out = []
    for src, log in sorted(logs.items()):
        name, spill = None, '?'
        for line in log.splitlines():
            m = re.search(r"entry function '(\w+)'", line)
            if m:
                names = re.findall(r'\d([a-z][a-z_]+?)(?=I|E)', m.group(1))
                tmpl = re.search(r'I((?:L[ib]n?\d+E)+)E', m.group(1))
                args = [a.replace('n', '-') for a in re.findall(
                    r'L[ib](n?\d+)E', tmpl.group(1))] if tmpl else []
                name = (f'{src} {max(names, key=len) if names else "?"}'
                        + (f'<{",".join(args)}>' if args else ''))
            m = re.search(r'(\d+) bytes spill stores', line)
            if m and name:
                spill = m.group(1)
            m = re.search(r'Used (\d+) registers', line)
            if m and name:
                out.append(f'{name}: {m.group(1)} regs, {spill} B spilled')
                name, spill = None, '?'
    return '; '.join(out)


def rate(work, fn, reps=5):
    """Work per second of fn() on the host clock around synchronised runs:
    the median of `reps` with the range beside it."""
    rates = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        rates.append(work / (time.perf_counter() - t))
    return (f'{statistics.median(rates):.6g} (range {min(rates):.6g}-'
            f'{max(rates):.6g} over {reps} runs)')


def leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for sub in tree for t in leaves(sub)]


def all_finite(tree):
    return all(bool(torch.isfinite(t).all()) for t in leaves(tree)
               if t.is_floating_point())


def bound(work):
    """(ms, 'bytes' or 'operations', unit) for a kernel's work: bytes
    ('hbm': each input read once, each output written once) and
    operations by unit ('fp32' FMAs on the f32 units, 'tf32' tensor-core
    multiply-adds, 'mufu' transcendentals, 'int' integer operations), each
    over its peak; the least time is the largest."""
    times = {u: work.get(u, 0) / rate * 1e3 for u, rate in PEAKS.items()}
    unit = max(times, key=times.get)
    return times[unit], 'bytes' if unit == 'hbm' else 'operations', unit


def estep_work(n, k, m, rows):
    """B1 (and S1/S2): per point K m multiply-adds for the logits and K m
    for the statistics, on the tensor cores at the precision rule's passes
    (the same work on the f32 units, one pass each, takes longer: 2 K m /
    33.5e12 against 9 K m / 247.5e12), K exps and a log; reads (rows, n)
    and theta (K, m), writes (K, m) + 1."""
    return {'tf32': (LOGIT_PASSES + STATS_PASSES) * n * k * m,
            'mufu': n * (k + 1), 'hbm': 4 * (rows * n + 2 * k * m + 1)}


def gibbs_work(xt, theta, n, m, kind=cuda_estep.GAUSS, p=0):
    """B2 at these inputs: K m multiply-adds for the logits per point on
    the tensor cores at the precision rule's passes, and m adds of the
    point's F row on the f32 units; and the draws this data needs: two logs for
    each component that can win (its logit plus the largest Gumbel draw,
    16, reaches the best logit plus the smallest, -3.9) and a
    Philox4x32-10 call of 10 rounds (2 mul-hi, 2 mul-lo, 4 xor, 2 key
    adds) for each group of 4 holding one; reads (rows, n) and theta,
    writes the labels and (K, m)."""
    k, m8 = theta.shape
    groups = cands = 0
    for s in range(0, n, 1 << 20):
        f = assemble_features(xt[:, s:min(s + (1 << 20), n)], m8, kind, p)
        logits = theta @ f
        live = logits + 16.0 >= logits.max(0).values - 3.9
        cands += int(live.sum())
        live = torch.cat([live, live.new_zeros(((-k) % 4, live.shape[1]))])
        groups += int(live.view(-1, 4, live.shape[1]).any(1).sum())
    return {'tf32': LOGIT_PASSES * n * k * m, 'fp32': n * m,
            'mufu': 2 * cands, 'int': 100 * groups,
            'hbm': 4 * (xt.shape[0] * n + n + 2 * k * m)}


def quad_fmas(d, diag=False):
    """Multiply-adds of one quadratic form over [1; x; x (x) x] at its
    least: x_a x_b and x_b x_a share one coefficient, so 1 + d + d (d + 1)
    / 2 (over the diagonal map [1; x; x^2], 1 + 2d)."""
    return 1 + 2 * d if diag else 1 + d + d * (d + 1) // 2


def point_products(d, diag=False):
    """Multiplies of a point's map entries x_a x_b (a <= b; or x_a^2),
    formed once per point and shared by every component."""
    return d if diag else d * (d + 1) // 2


def density_work(n, k, m, d, mufu_per_comp, quads=1, products=0):
    """B3 / B4: `quads` quadratic forms per component, each one multiply-
    add per coefficient it needs (m: B3's quad_fmas; B4's d rows of
    (k, j), 3 each: 1, x_j, x_j^2) and `products` multiplies per point
    for the map's entries, the given transcendentals per component and a
    log per point; reads (d, n), writes (n,)."""
    return {'fp32': n * (k * quads * m + products),
            'mufu': n * (k * mufu_per_comp + 1), 'hbm': 4 * (d * n + n)}


def b4_work(n, d, aux):
    """B4 at these coefficients: per component d scaled squares (3
    multiply-adds each) and, where its tail exponent h is the same in
    every dim (aux[:, 1] > 0), one log and one exp (h sum_j log1p(u_j) =
    h log1p(U)); else d logs and an exp."""
    k = aux.shape[0]
    shared = int((aux[:, 1] > 0).sum())
    return {'fp32': n * (k * 3 * d + point_products(d, True)),
            'mufu': n * (2 * shared + (d + 1) * (k - shared) + 1),
            'hbm': 4 * (d * n + n)}


LIBRARY = {}    # kernel name -> ms of one PyTorch call of the same function


def library_mixture(post, log_w, x, dist='studentt'):
    """The one PyTorch call that computes B4's function (dist='studentt':
    the mixture of products of univariate t's) or B3-diag's ('gaussian':
    of diagonal Gaussians) for an NG posterior: MixtureSameFamily over
    Independent(StudentT or Normal), run on 1e6-point chunks of x (N, d)."""
    mu, lam, df = ng.predictive_studentt_params(post)
    base = (torch.distributions.StudentT(df, mu, lam.rsqrt())
            if dist == 'studentt' else
            torch.distributions.Normal(mu, lam.rsqrt()))
    mix = torch.distributions.MixtureSameFamily(
        torch.distributions.Categorical(logits=log_w),
        torch.distributions.Independent(base, 1))

    def run():
        return torch.cat([mix.log_prob(x[s:s + 1_000_000])
                          for s in range(0, x.shape[0], 1_000_000)])
    return run


def profiled_device_ms(fn, reps=20, tries=3):
    """Device time per call of fn() under torch.profiler (the summed
    device events of `reps` calls over reps). On an H100 host a
    profiling session now and then records no device event at all (for
    a kernel of this library in one session, for `2.0 * x` in another);
    such a session is run again, up to `tries` in all. None: none
    recorded any."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
        if total > 0:
            return total / 1e3 / reps
    return None


def ms_text(ms):
    """A time in ms for the printed lines; None is 'not measured'."""
    return 'not measured' if ms is None else f'{ms:.6g} ms'


def serving_work(n, k, d, p, diag=False):
    """B5 / B6, the least work of the function whatever computes it: per
    component the basis and c quads over [1; x; x (x) x] (quad_fmas each,
    on the point's products formed once), p expert means (1 + d each) and
    the y tail from the residuals y - mu: (y - mu)' psi (y - mu) (p + p (p
    + 1) / 2) for MNW experts, p scaled squares (2p) for MNG; per
    component a log1p for the basis, an exp for the weight, a log of c,
    one log1p of the tail (p for MNG, p > 1) and an exp for the NLPD, and
    2 logs per point; reads (d + p, n), writes 2p + 2 rows."""
    tail = 2 * p if diag or p == 1 else p + p * (p + 1) // 2
    mufu = 4 + (p if diag else 1)
    return {'fp32': n * (k * (2 * quad_fmas(d) + p * (1 + d) + tail)
                         + point_products(d)),
            'mufu': n * (k * mufu + 2),
            'hbm': 4 * ((d + p) * n + (2 * p + 2) * n)}


def precision_check(tag, xt, theta, n, kind=cuda_estep.GAUSS, p=0,
                    got=None):
    """B1's error against float64 beside the f32 plain version's: lse
    relative, statistics as max |err| / summed magnitude. Fails when the
    kernel's is more than 10x the plain version's (the precision rule,
    csrc/estep.cuh), the plain version's counted as at least half an f32
    ulp (2^-24): no f32 result is nearer than that but by chance. `got`:
    the kernel's (acc, lse) at theta where it ran already (one chain of
    a chain launch)."""
    acc, lse = got if got is not None else cuda_estep.estep(xt, theta, n,
                                                            kind, p)
    pacc, plse = cuda_estep.estep_plain(xt, theta, n, kind, p)
    acc64, lse64 = cuda_estep.estep_plain(xt.double(), theta.double(), n,
                                          kind, p)
    mag = estep_magnitudes(xt, theta, n, kind, p).clamp(min=1e-30)

    def rel(a, l):
        return (float(((a.double() - acc64).abs() / mag).max()),
                abs(float(l) - float(lse64)) / abs(float(lse64)))

    (ks, kl), (ps, pl) = rel(acc, lse), rel(pacc, plse)
    ratio_s, ratio_l = ks / max(ps, 2.0 ** -24), kl / max(pl, 2.0 ** -24)
    ok = ratio_s <= 10 and ratio_l <= 10
    print(f'precision B1 {tag}: vs float64, lse relative error kernel '
          f'{kl:.3g}, f32 plain {pl:.3g} ({ratio_l:.3g}x); statistics max '
          f'|err| / summed magnitude kernel {ks:.3g}, f32 plain {ps:.3g} '
          f'({ratio_s:.3g}x) (<= 10x, the plain error counted as at least '
          f'2^-24) {"ok" if ok else "FAIL"}')
    check(ok, f'B1 {tag} less precise than 10x the f32 plain version')


def quad_centres(th, d, diag=False):
    """(mu (K, d), sigma (K,)) of quadratic-form rows th (K, m8) over the
    Gauss map [1; x; x (x) x] (or the diagonal map [1; x; x^2]) that are
    (x - mu)' Lmbda (x - mu): the centre -Lmbda^-1 g / 2 and the largest
    scale lambda_min(Lmbda)^-1/2, in float64."""
    t = th.double()
    k = t.shape[0]
    g = t[:, 1:1 + d]
    if diag:
        lm = torch.diag_embed(t[:, 1 + d:1 + 2 * d])
    else:
        lm = t[:, 1 + d:1 + d + d * d].reshape(k, d, d)
        lm = 0.5 * (lm + lm.transpose(1, 2))
    mu = -0.5 * torch.linalg.solve(lm, g)
    sigma = torch.linalg.eigvalsh(lm)[:, 0].clamp(min=1e-300) ** -0.5
    return mu, sigma


def off_origin_shift(mu, sigma):
    """u = T (1, ..., 1) that puts every component centre mu_k at least
    10 sigma_k from the origin (|u| - |mu_k| >= 10 sigma_k); returns
    (u, min_k |mu_k + u| / sigma_k)."""
    d = mu.shape[1]
    t = float((mu.norm(dim=-1) + 10.0 * sigma).max()) / math.sqrt(d) * 1.01
    u = torch.full((d,), t, dtype=torch.float64, device=mu.device)
    return u, float(((mu + u).norm(dim=-1) / sigma).min())


def translate_rows(th, d, u, diag=False, p=0):
    """Coefficient rows for data whose x is translated by u: th' with
    th' . F(x + u) = th . F(x) for every row, F the Gauss map (p = 0),
    the diagonal map, or B6's joint map [1; x; x (x) x; y; x (x) y;
    y (x) y] with y untouched (p > 0). Each row is a quadratic
    c + g'z + z'Hz; with x = x' - u its constant becomes c - g_x'u +
    u'H_xx u, its x part g_x - (H_xx + H_xx')u, its y part g_y - H_xy'u.
    Formed in float64 and returned in float32."""
    t = th.double().clone()
    u = u.double()
    k = t.shape[0]
    g = t[:, 1:1 + d].clone()
    if diag:
        h = t[:, 1 + d:1 + 2 * d]
        t[:, 0] += -(g @ u) + (h * u * u).sum(-1)
        t[:, 1:1 + d] = g - 2.0 * h * u
    else:
        hh = t[:, 1 + d:1 + d + d * d].reshape(k, d, d)
        t[:, 0] += -(g @ u) + torch.einsum('a,kab,b->k', u, hh, u)
        t[:, 1:1 + d] = g - torch.einsum('kab,b->ka', hh + hh.transpose(1, 2),
                                         u)
        if p:
            o = 1 + d + d * d
            hxy = t[:, o + p:o + p + d * p].reshape(k, d, p)
            t[:, o:o + p] -= torch.einsum('kij,i->kj', hxy, u)
    return t.float().contiguous()


def translate_b4_rows(rows, d, u):
    """B4's rows (K d, 4) = [c, g, h, tail exponent] of c + g x_j + h x_j^2
    for data whose x is translated by u: c - g u_j + h u_j^2, g - 2 h u_j.
    Formed in float64 and returned in float32."""
    t = rows.double().clone()
    uj = u.double().repeat(t.shape[0] // d)
    c, g, h = t[:, 0].clone(), t[:, 1].clone(), t[:, 2]
    t[:, 0] = c - g * uj + h * uj * uj
    t[:, 1] = g - 2.0 * h * uj
    return t.float().contiguous()


PRECISION = {}    # (kernel, cell) -> its worst ratio to the f32 plain error


def serving_precision(name, cell, kern, plain, args, rows, note=''):
    """Step 0's float64 line of a serving kernel (B3-B6): its outputs on
    its own f32 inputs `args` against the plain version on the same inputs
    upcast to float64, beside the f32 plain version's error. `rows` names
    the output rows: ('nats', label) for log densities, NLPD and lse_w
    (max |err|), ('rel', label) for means and variances (max |err| / max
    |value|). Fails when the kernel's error is more than 10x the plain
    version's, the plain error counted as at least 2^-24 of the row's
    magnitude."""
    got, want = kern(*args), plain(*args)
    ref = plain(*[a.double() if torch.is_tensor(a) else a for a in args])
    if ref.dim() == 1:
        got, want, ref = got[None], want[None], ref[None]
    parts, worst = [], 0.0
    for (unit, label), g, w, r in zip(rows, got, want, ref):
        r = r.double()
        mag = max(float(r.abs().max()), 1e-300)
        ek = float((g.double() - r).abs().max())
        ep = float((w.double() - r).abs().max())
        ratio = ek / max(ep, 2.0 ** -24 * mag)
        worst = max(worst, ratio)
        scale = 1.0 if unit == 'nats' else 1.0 / mag
        parts.append(f'{label} {ek * scale:.3g} vs {ep * scale:.3g} '
                     f'({ratio:.3g}x)')
    ok = worst <= 10.0
    PRECISION[(name, cell)] = worst
    print(f'precision {name} {cell}{note}: vs float64, kernel vs f32 plain '
          f'(nats; mean and var relative): {"; ".join(parts)}; worst '
          f'{worst:.3g}x (<= 10x, the plain error counted as at least 2^-24 '
          f'of the magnitude) {"ok" if ok else "FAIL"}')
    check(ok, f'{name} {cell} less precise than 10x the f32 plain version')


def serving_precision_cells(name, kern, plain, xt, th, rest, rows, d,
                            basis_rows, diag=False, p=0, centres=None,
                            translate=None):
    """serving_precision at the kernel's main cell (xt, th) and at its
    off-origin cell: the x rows of xt translated by u and th's rows with
    them (`translate`(th, d, u), by default translate_rows), u putting
    every component's centre (from the quad rows th[basis_rows], or
    `centres` = (mu, sigma)) at least 10 sigma from the origin."""
    serving_precision(name, 'main', kern, plain, (xt, th) + rest, rows)
    mu, sigma = centres or quad_centres(th[basis_rows], d, diag)
    u, dist = off_origin_shift(mu, sigma)
    xo = xt.clone()
    xo[:d] += u.float()[:, None]
    tho = (translate(th, d, u) if translate else
           translate_rows(th, d, u, diag, p))
    serving_precision(name, 'off-origin', kern, plain, (xo, tho) + rest, rows,
                      f' (x + {float(u[0]):.4g}, centres >= {dist:.3g} sigma '
                      f'out)')


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is false: this script needs a card')
    torch.cuda.set_device(0)
    run(torch.device('cuda:0'), args.seed, N_MAIN, N_CHECK)


def run(dev, seed, n_main, n_check):
    spec = gaussian_spec()

    # -- 1. card ------------------------------------------------------------
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader', '--id=0'],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f'card: torch {torch.__version__}, CUDA {torch.version.cuda}, '
          f'{torch.cuda.get_device_name(0)}, '
          f'{torch.cuda.device_count()} device(s) visible')

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.load()
    print(f'build: {time.perf_counter() - t0:.3f} s to load, nvcc '
          f'{lib.build_seconds:.3f} s (one process per source, in '
          f'parallel), {lib.path}')
    if lib.logs:
        print(f'build: ptxas {ptxas_summary(lib.logs)}')

    gen = torch.Generator(device=dev).manual_seed(seed)
    errs, launches, ms = {}, {}, {}

    # S3, the toolchain probe, first: o = 2 x on (8, 128) f32, exactly
    cuda_hello.launches = 0
    x_hello = torch.randn((8, 128), generator=gen, device=dev)
    o_hello = cuda_hello.twice(x_hello)
    torch.cuda.synchronize()
    launches['S3'] = cuda_hello.launches
    errs['S3'] = float((o_hello - cuda_hello.twice_plain(x_hello)).abs().max())
    print(f'S3 build probe: 2 x on (8, 128) f32, launches '
          f'{launches["S3"]}, max|err| {errs["S3"]:.6g} (must be 0)')
    check(launches['S3'] == 1 and errs['S3'] == 0.0, 'S3 probe disagrees')

    # -- 3. B1 vs plain -----------------------------------------------------
    for n, k, d in ((n_check, K_MAIN, D_MAIN), (1000, 7, 3)):
        post = random_posterior(gen, k, d, dev)
        sb = StickBreaking(
            gamma=1.0 + 1e5 * torch.rand((k,), generator=gen, device=dev),
            delta=1.0 + 1e5 * torch.rand((k,), generator=gen, device=dev))
        log_pi = sb.expected_log_pi()
        xt = (torch.randn((d, n), generator=gen, device=dev) * 4.0
              + post.mu[0][:, None])
        theta, _ = pad_theta(spec.theta(post), log_pi, torch.float32)
        acc, lse = cuda_estep.estep(xt, theta, n)
        acc2, lse2 = cuda_estep.estep(xt, theta, n)
        pacc, plse = cuda_estep.estep_plain(xt, theta, n)
        torch.cuda.synchronize()
        atol = 1e-3 * n / 1e6
        ok_s, err_s = allclose_report(acc, pacc, 1e-4, atol)
        ok_l, err_l = allclose_report(lse, plse, 1e-5, 0.0)
        bitwise = torch.equal(acc, acc2) and torch.equal(lse, lse2)
        print(f'B1 N={n} K={k} d={d}: stats max|err| {err_s:.6g} '
              f'(rtol 1e-4, atol {atol:.6g}) {"ok" if ok_s else "FAIL"}; '
              f'lse {float(lse):.9g} vs {float(plse):.9g}, |err| '
              f'{err_l:.6g} (rtol 1e-5) {"ok" if ok_l else "FAIL"}; '
              f'bitwise repeat {bitwise}')
        check(ok_s and ok_l and bitwise, f'B1 disagrees at N={n}')
        if d == D_MAIN:
            errs['B1'] = err_s
            b1_post, b1_log_pi, b1_xt = post, log_pi, xt

    # -- 4. B2 vs plain -----------------------------------------------------
    k, m8 = K_MAIN, 8
    theta, _ = pad_theta(spec.theta_plugin(mode_params(b1_post)), b1_log_pi,
                         torch.float32)
    sweep_seed = torch.randint(0, 2 ** 62, (), generator=gen, device=dev)
    labels, acc = cuda_gibbs.gibbs(b1_xt, theta, sweep_seed, n_check)
    plabels, _ = cuda_gibbs.gibbs_plain(b1_xt, theta, sweep_seed, n_check)
    f = assemble_features(b1_xt, m8).double()
    oh = torch.nn.functional.one_hot(labels.long(), k).double()
    ref, mag = oh.T @ f.T, oh.T @ f.abs().T
    err = (acc.double() - ref).abs()
    ok_acc = bool((err <= 1e-5 * mag).all())
    in_range = int(labels.min()) >= 0 and int(labels.max()) < k
    mismatch = float((labels != plabels).double().mean())
    errs['B2'] = float(err.max())
    print(f'B2 N={n_check} K={k}: labels in [0, {k}) {in_range}; stats vs '
          f'one-hot sums of its labels max|err| {errs["B2"]:.6g} (<= 1e-5 x '
          f'summed magnitudes) {"ok" if ok_acc else "FAIL"}; label mismatch '
          f'vs plain Philox {mismatch:.3g} (<= 1e-4)')
    check(in_range and ok_acc and mismatch <= 1e-4, 'B2 disagrees')
    fast_err = cuda_gibbs.gumbel_fast_error(dev)
    print(f'B2 fast draw: worst |error| over all 2^23 uniforms '
          f'{fast_err:.3g} against float64 (exact labels need < 2^-11; '
          f'checked < 2^-12)')
    check(fast_err < 2.0 ** -12, 'B2 fast draw off its bound')

    # frequencies need overlapping components: unit-scale plug-in params
    wide = GaussParams(
        mu=torch.randn((k, D_MAIN), generator=gen, device=dev),
        lmbda=0.5 * torch.eye(D_MAIN, device=dev).expand(k, D_MAIN, D_MAIN))
    th_f, _ = pad_theta(spec.theta_plugin(wide),
                        torch.full((k,), -math.log(k), device=dev),
                        torch.float32)
    xs = torch.tensor([[0.0, 0.0], [1.0, -1.0], [-0.5, 2.0], [0.3, 0.3]],
                      device=dev)
    reps = 1 << 18                                   # 2^20 points in all
    xf = xs.repeat_interleave(reps, 0).T.contiguous()
    lab, _ = cuda_gibbs.gibbs(xf, th_f, sweep_seed + 1, xf.shape[1])
    probs = torch.softmax(th_f.double() @ assemble_features(
        xs.T.contiguous(), m8).double(), 0).T         # (4, K)
    worst = 0.0
    for i in range(4):
        cnt = torch.bincount(lab[i * reps:(i + 1) * reps].long(),
                             minlength=k).double()
        sigma = torch.sqrt(reps * probs[i] * (1 - probs[i]))
        z = ((cnt - reps * probs[i]).abs() / torch.clamp(sigma, min=1e-12))
        worst = max(worst, float(z[probs[i] * reps >= 1].max()))
        check(bool(((cnt - reps * probs[i]).abs() <= 5 * sigma + 1).all()),
              f'B2 label frequencies at point {i} off the softmax')
    print(f'B2 frequencies: 2^20 draws at 4 points, worst |z| {worst:.3f} '
          f'over components with >= 1 expected draw (bound 5 sigma) ok')

    streamed_checks(dev, gen, card, spec, n_check)

    # -- 5. B3 vs plain -----------------------------------------------------
    log_w = torch.log_softmax(
        torch.randn((k,), generator=gen, device=dev), 0)
    errs['B3'] = 0.0
    for dist in ('studentt', 'gaussian'):
        thq, aux = cuda_predict.predictive_coefficients(
            b1_post, log_w, dist == 'studentt')
        out = cuda_predict.predict(b1_xt, thq, aux, n_check,
                                   dist == 'studentt')
        pout = cuda_predict.predict_plain(b1_xt, thq, aux, n_check,
                                          dist == 'studentt')
        ok, e = allclose_report(out, pout, 1e-5, 1e-4)
        errs['B3'] = max(errs['B3'], e)
        print(f'B3 {dist} N={n_check} K={k}: max|err| {e:.6g} nats '
              f'(rtol 1e-5, atol 1e-4) {"ok" if ok else "FAIL"}; finite '
              f'{bool(torch.isfinite(out).all())}')
        check(ok and bool(torch.isfinite(out).all()), f'B3 {dist} disagrees')

    # -- 6. main path -------------------------------------------------------
    kg = torch.Generator(device=dev).manual_seed(seed)
    mu = torch.randn((3, D_MAIN), generator=kg, device=dev) * 4.0
    lm = torch.eye(D_MAIN, device=dev).expand(3, D_MAIN, D_MAIN) * 2.0
    x, _ = BayesianGMM.generate(kg, GaussParams(mu, lm), [.3, .4, .3],
                                n_main)
    model = BayesianGMM.make(size=K_MAIN, dim=D_MAIN, gating='dp', alpha=1.0,
                             kappa=0.05, psi_scale=0.5, device=dev)
    torch.cuda.synchronize()
    reset_counts()
    st, vlb = model.fit_vi_fused(x, key=1, maxiter=20)
    algebra = {'VI 20': algebra_counts()}
    reset_algebra_counts()
    gs = model.fit_gibbs_fused(x, key=2, maxiter=20)
    algebra['Gibbs 20'] = algebra_counts()
    lp = model.log_predictive(st, x)
    torch.cuda.synchronize()
    path = read_counts()
    launches.update(B1=path['B1'], B2=path['B2'], B3=path['B3'])
    print(f'main N={n_main} K={K_MAIN} d={D_MAIN}: launches {path}; '
          f'K-sized algebra (factorizations, prior constants) {algebra}')
    check(path['B1'] == 20 and path['B2'] == 20 and path['B3'] >= 1,
          'the main path bypassed a kernel')

    v = vlb.double()
    rel_drop = float(((v[:-1] - v[1:]) / v[1:].abs()).max())
    print(f'main VI: ELBO {float(v[0]):.9g} -> {float(v[-1]):.9g}, worst '
          f'relative drop {rel_drop:.3g} (<= 1e-4)')
    check(bool(torch.isfinite(v).all()) and rel_drop <= 1e-4,
          'VI ELBO not finite or decreasing')
    leaves = (gs.components.mu, gs.components.psi, gs.components.nu,
              gs.gating.gamma, gs.gating.delta, gs.params.mu,
              gs.params.lmbda, gs.log_pi)
    check(all(bool(torch.isfinite(t).all()) for t in leaves)
          and gs.labels.shape == (n_main,)
          and 0 <= int(gs.labels.min()) and int(gs.labels.max()) < K_MAIN,
          'Gibbs state not finite or labels out of range')
    check(lp.shape == (n_main,) and bool(torch.isfinite(lp).all()),
          'log_predictive not finite')
    w_vi = st.gating.mean()
    top = torch.argsort(w_vi, descending=True)[:3]
    dist_mu = torch.cdist(mu, st.components.mu[top]).min(1).values
    counts = torch.bincount(gs.labels.long(), minlength=K_MAIN)
    print(f'main fit: VI top-3 weights {[round(float(w), 4) for w in w_vi[top]]}'
          f', true means within {float(dist_mu.max()):.4g}; Gibbs components '
          f'with >= 20% of points {int((counts >= 0.2 * n_main).sum())}; '
          f'mean log predictive {float(lp.mean()):.6g}')

    # the engines' kernel path against their plain path on a slice
    xs_ = x[:100_003]
    _, v_k = model.fit_vi_fused(xs_, maxiter=5, init_state=st,
                                randomize=False, backend='kernel')
    _, v_t = model.fit_vi_fused(xs_, maxiter=5, init_state=st,
                                randomize=False, backend='torch')
    ok_v, e_v = allclose_report(v_k, v_t, 1e-4, 0.0)
    ok_p, e_p = allclose_report(model.log_predictive(st, xs_, backend='kernel'),
                                model.log_predictive(st, xs_, backend='torch'),
                                1e-5, 1e-4)
    print(f'main vs plain on 100,003 points: VI ELBO max|err| {e_v:.6g} '
          f'(rtol 1e-4) {"ok" if ok_v else "FAIL"}; log_predictive max|err| '
          f'{e_p:.6g} (rtol 1e-5, atol 1e-4) {"ok" if ok_p else "FAIL"}')
    check(ok_v and ok_p, 'kernel path disagrees with the plain path')

    # rates (warm: every kernel has run above); host clock around
    # synchronised runs, median of 5 with the range beside it
    vi = rate(20, lambda: model.fit_vi_fused(x, maxiter=20, init_state=st,
                                             randomize=False))
    gibbs = rate(20, lambda: model.fit_gibbs_fused(x, key=3, maxiter=20))
    pred = rate(n_main, lambda: model.log_predictive(st, x))
    print(f'rates on {card} at N={n_main} K={K_MAIN} d={D_MAIN}: VI {vi} '
          f'it/s (20 warm-started sweeps); Gibbs {gibbs} sweeps/s (20 '
          f'sweeps); predictive {pred} pts/s')

    # each kernel beside its plain version, same inputs, main-path shape
    xt = kernel_xts((x,))[0]
    th_vi, _ = pad_theta(spec.theta(st.components),
                         st.gating.expected_log_pi(), torch.float32)
    th_g, _ = pad_theta(spec.theta_plugin(gs.params), gs.log_pi,
                        torch.float32)
    thq, aux = cuda_predict.predictive_coefficients(
        st.components, model.predictive_log_weights(st))
    sweep_seed = torch.zeros((), dtype=torch.int64, device=dev)
    pairs = {
        'B1': (lambda: cuda_estep.estep(xt, th_vi, n_main),
               lambda: cuda_estep.estep_plain(xt, th_vi, n_main)),
        'B2': (lambda: cuda_gibbs.gibbs(xt, th_g, sweep_seed, n_main),
               lambda: cuda_gibbs.gibbs_plain(xt, th_g, sweep_seed, n_main)),
        'B3': (lambda: cuda_predict.predict(xt, thq, aux, n_main),
               lambda: cuda_predict.predict_plain(xt, thq, aux, n_main)),
    }
    m = cuda_estep.feature_width(cuda_estep.GAUSS, D_MAIN)
    WORK.update(B1=estep_work(n_main, K_MAIN, m, D_MAIN),
                B2=gibbs_work(xt, th_g, n_main, m),
                B3=density_work(n_main, K_MAIN, quad_fmas(D_MAIN), D_MAIN, 2,
                                products=point_products(D_MAIN)))
    for name, (kern, plain) in pairs.items():
        ms[name] = (cuda_ms(kern, 20), cuda_ms(plain, 3))
        print(f'{name} time on {card} at N={n_main} K={K_MAIN} d={D_MAIN}: '
              f'kernel {ms[name][0]:.6g} ms, plain PyTorch {ms[name][1]:.6g}'
              f' ms')
    gauss_predictive_row(model, st, x, xt, card, errs, launches, ms)
    precision_check(f'main N={n_main} K={K_MAIN} d={D_MAIN}', xt, th_vi,
                    n_main)
    serving_precision_cells('B3', cuda_predict.predict,
                            cuda_predict.predict_plain, xt, thq, (aux, n_main),
                            (('nats', 'log density'),), D_MAIN, slice(None))

    del x, xt, model, st, gs, lp
    torch.cuda.empty_cache()

    ilr_kernel_checks(dev, gen, card, errs)
    ilr_fit_path(dev, seed, card, errs, launches, ms)
    ilr_serving_paths(dev, seed, card, launches, ms)
    diag_kernel_checks(dev, gen, errs)
    diag_gmm_path(dev, seed, card, n_main, errs, launches, ms)
    ilr_serving_paths(dev, seed, card, launches, ms, diag=True)
    branch_checks(dev, gen, errs)
    probe_checks(dev, gen, card, n_main, errs, launches, ms)
    tied_gmm_paths(dev, seed, card, n_main, errs, launches, ms)
    hilr_serving_paths(dev, seed, card, errs, launches, ms)
    wide = wide_serving_paths(dev, gen, card, errs, launches, ms)
    engine_paths(dev, seed, card, n_main, errs, launches, ms)
    nested_paths(dev, seed, card, errs, launches, ms)
    chain_rows = chain_paths(dev, seed, card, n_main, errs, launches, ms)
    stream_paths(dev, seed, card, n_main, errs, launches, ms)
    mesh_paths(dev, seed, card, n_main, errs, launches, ms)
    t22 = time.perf_counter()
    mesh_stream_dense_paths(dev, seed, card, n_main, errs, launches, ms)
    print(f'phase 22 on {card}: {time.perf_counter() - t22:.6g} s')
    t23 = time.perf_counter()
    certify_paths(dev, seed, card, n_main, errs, launches, ms)
    print(f'phase 23 on {card}: {time.perf_counter() - t23:.6g} s')
    t24 = time.perf_counter()
    examples_paths(dev, card, errs, launches, ms)
    print(f'phase 24 on {card}: {time.perf_counter() - t24:.6g} s')
    t25 = time.perf_counter()
    diag_basis_paths(dev, seed, card, errs, launches, ms)
    print(f'phase 25 on {card}: {time.perf_counter() - t25:.6g} s')
    t26 = time.perf_counter()
    dense_chain_paths(dev, seed, card)
    print(f'phase 26 on {card}: {time.perf_counter() - t26:.6g} s')
    t27 = time.perf_counter()
    fed_paths(dev, seed, card, errs, launches, ms)
    print(f'phase 27 on {card}: {time.perf_counter() - t27:.6g} s')
    ms['S3'] = (cuda_ms(lambda: cuda_hello.twice(x_hello), 20),
                cuda_ms(lambda: cuda_hello.twice_plain(x_hello), 20))
    WORK['S3'] = {'hbm': 2 * 4 * x_hello.numel()}
    LIBRARY['S3'] = cuda_ms(lambda: 2.0 * x_hello, 20)
    # the CUDA-event times above are per call of 20 back to back, host
    # launch paths included; the profiler's device time shows the kernels
    s3_dev = (profiled_device_ms(lambda: cuda_hello.twice(x_hello)),
              profiled_device_ms(lambda: 2.0 * x_hello))
    print(f'S3 on {card}: kernel {ms["S3"][0]:.6g} ms a call by CUDA events '
          f'(device {ms_text(s3_dev[0])} by the profiler), 2.0 * x '
          f'{LIBRARY["S3"]:.6g} ms (device {ms_text(s3_dev[1])})')

    meta = {
        'B1': ('B1 fused VI E-step', 'mimo_tpu_torch/csrc/estep.cuh',
               'mimo_tpu/ops/pallas_estep.py:164'),
        'B2': ('B2 fused Gibbs label sweep', 'mimo_tpu_torch/csrc/gibbs.cuh',
               'mimo_tpu/ops/pallas_gibbs.py:36'),
        'B3': ('B3 Student-t mixture predictive',
               'mimo_tpu_torch/csrc/predict.cu',
               'mimo_tpu/ops/pallas_predict.py:39'),
        'B3-gauss': ('B3 moment-matched Gaussian mixture predictive (NIW)',
                     'mimo_tpu_torch/csrc/predict.cu',
                     'mimo_tpu/ops/pallas_predict.py:39'),
        'B1-ILR': ('B1 fused VI E-step, ILR feature map',
                   'mimo_tpu_torch/csrc/estep.cuh',
                   'mimo_tpu/ops/pallas_estep.py:164'),
        'B2-ILR': ('B2 fused Gibbs label sweep, ILR feature map',
                   'mimo_tpu_torch/csrc/gibbs.cuh',
                   'mimo_tpu/ops/pallas_gibbs.py:36'),
        'B1-ILR-diagbasis': ('B1 fused VI E-step, ILR feature map over a '
                             'diagonal (NG) basis',
                             'mimo_tpu_torch/csrc/estep.cuh',
                             'mimo_tpu/ops/pallas_estep.py:164'),
        'B2-ILR-diagbasis': ('B2 fused Gibbs label sweep, ILR feature map '
                             'over a diagonal (NG) basis',
                             'mimo_tpu_torch/csrc/gibbs.cuh',
                             'mimo_tpu/ops/pallas_gibbs.py:36'),
        'B5': ('B5 ILR predict, p=1', 'mimo_tpu_torch/csrc/ilr_predict.cuh',
               'mimo_tpu/ops/pallas_predict.py:656'),
        'B6': ('B6 ILR predict, p>1', 'mimo_tpu_torch/csrc/ilr_predict.cuh',
               'mimo_tpu/ops/pallas_predict.py:349'),
        'B1-diag': ('B1 fused VI E-step, diagonal feature map',
                    'mimo_tpu_torch/csrc/estep.cuh',
                    'mimo_tpu/ops/pallas_estep.py:164'),
        'B2-diag': ('B2 fused Gibbs label sweep, diagonal feature map',
                    'mimo_tpu_torch/csrc/gibbs.cuh',
                    'mimo_tpu/ops/pallas_gibbs.py:36'),
        'B3-diag': ('B3 Gaussian mixture predictive, diagonal feature map',
                    'mimo_tpu_torch/csrc/predict.cu',
                    'mimo_tpu/ops/pallas_predict.py:39'),
        'B4': ('B4 diagonal (NG) Student-t mixture predictive',
               'mimo_tpu_torch/csrc/diag_predict.cu',
               'mimo_tpu/ops/pallas_predict.py:171'),
        'B5-MNG': ('B5 ILR predict, p=1, MNG experts',
                   'mimo_tpu_torch/csrc/ilr_predict.cuh',
                   'mimo_tpu/ops/pallas_predict.py:656'),
        'B6-MNG': ('B6 ILR predict, p>1, MNG tail',
                   'mimo_tpu_torch/csrc/ilr_predict.cuh',
                   'mimo_tpu/ops/pallas_predict.py:349'),
        'B3-hier': ('B3 Student-t mixture predictive, HierTied rows',
                    'mimo_tpu_torch/csrc/predict.cu',
                    'mimo_tpu/ops/pallas_predict.py:39'),
        'B1-tied': ('B1 fused VI E-step, Gauss map, pooled (tied) NIW theta',
                    'mimo_tpu_torch/csrc/estep.cuh',
                    'mimo_tpu/ops/pallas_estep.py:164'),
        'B2-tied': ('B2 fused Gibbs label sweep, Gauss map, exact tied draws',
                    'mimo_tpu_torch/csrc/gibbs.cuh',
                    'mimo_tpu/ops/pallas_gibbs.py:36'),
        'B1-diag-tied': ('B1 fused VI E-step, diagonal map, pooled NG theta',
                         'mimo_tpu_torch/csrc/estep.cuh',
                         'mimo_tpu/ops/pallas_estep.py:164'),
        'B2-diag-tied': ('B2 fused Gibbs label sweep, diagonal map, exact '
                         'tied NG draws', 'mimo_tpu_torch/csrc/gibbs.cuh',
                         'mimo_tpu/ops/pallas_gibbs.py:36'),
        'B4-tied': ('B4 diagonal Student-t predictive, pooled NG',
                    'mimo_tpu_torch/csrc/diag_predict.cu',
                    'mimo_tpu/ops/pallas_predict.py:171'),
        'B1-hier': ('B1 fused VI E-step, Gauss map, hierarchical theta',
                    'mimo_tpu_torch/csrc/estep.cuh',
                    'mimo_tpu/ops/pallas_estep.py:164'),
        'B2-hier': ('B2 fused Gibbs label sweep, Gauss map, exact '
                    'hierarchical draws', 'mimo_tpu_torch/csrc/gibbs.cuh',
                    'mimo_tpu/ops/pallas_gibbs.py:36'),
        'B1-ILR-hilr': ('B1 fused VI E-step, ILR map, HierTied basis x '
                        'tied-affine experts', 'mimo_tpu_torch/csrc/estep.cuh',
                        'mimo_tpu/ops/pallas_estep.py:164'),
        'B2-ILR-hilr': ('B2 fused Gibbs label sweep, ILR map, HierTied basis '
                        'x tied-affine experts',
                        'mimo_tpu_torch/csrc/gibbs.cuh',
                        'mimo_tpu/ops/pallas_gibbs.py:36'),
        'B5-hilr': ('B5 ILR predict, p=1, tied-affine experts and HierTied '
                    'basis branches', 'mimo_tpu_torch/csrc/ilr_predict.cuh',
                    'mimo_tpu/ops/pallas_predict.py:656'),
        'B6-hilr': ('B6 ILR predict, p>1, tied-affine experts and HierTied '
                    'basis branches', 'mimo_tpu_torch/csrc/ilr_predict.cuh',
                    'mimo_tpu/ops/pallas_predict.py:349'),
        'S1-divide': ('S1 B1 probe, normalised (B1 itself)',
                      'mimo_tpu_torch/csrc/probes.cu',
                      'scripts/bisect_pallas.py:51'),
        'S1-nodivide': ('S1 B1 probe, no normalisation',
                        'mimo_tpu_torch/csrc/probes.cu',
                        'scripts/bisect_pallas.py:51'),
        'S2-none': ('S2 B1 probe, no valid count',
                    'mimo_tpu_torch/csrc/probes.cu',
                    'scripts/bisect_smem.py:44'),
        'S2-unused': ('S2 B1 probe, valid count in device memory, unused',
                      'mimo_tpu_torch/csrc/probes.cu',
                      'scripts/bisect_smem.py:48'),
        'S2-used': ('S2 B1 probe, valid count in device memory, used',
                    'mimo_tpu_torch/csrc/probes.cu',
                    'scripts/bisect_smem.py:52'),
        'S3': ('S3 build probe o = 2x', 'mimo_tpu_torch/csrc/hello.cu',
               'scripts/pallas_hello.py:11'),
        'B2-geweke': (f'B2 fused Gibbs label sweep, the Geweke transition '
                      f'(n={GEWEKE_N}, K={GEWEKE_K}, Gauss map)',
                      'mimo_tpu_torch/csrc/gibbs.cuh',
                      'mimo_tpu/ops/pallas_gibbs.py:36'),
        'B5-eval': ('B5 ILR predict, p=1, the ilr_eval sine fit (N=2000, '
                    'K=50, d=1)', 'mimo_tpu_torch/csrc/ilr_predict.cuh',
                    'mimo_tpu/ops/pallas_predict.py:656'),
        'B5-eval-poly': ('B5 ILR predict, p=1, the ilr_eval step_poly fit '
                         '(N=160, K=10, cubic features d=3)',
                         'mimo_tpu_torch/csrc/ilr_predict.cuh',
                         'mimo_tpu/ops/pallas_predict.py:656'),
        'B1-MAP': ('B1 fused E-step, Gauss map, plug-in theta at the '
                   'posterior mode (fit_map_fused)',
                   'mimo_tpu_torch/csrc/estep.cuh',
                   'mimo_tpu/ops/pallas_estep.py:164'),
        'B1-EM': ('B1 fused E-step, Gauss map, plug-in theta of the ML '
                  'params (fit_em_fused)', 'mimo_tpu_torch/csrc/estep.cuh',
                  'mimo_tpu/ops/pallas_estep.py:164'),
        'B1-ILR-MAP': ('B1 fused E-step, ILR map, plug-in theta at the '
                       'posterior mode (fit_map_fused)',
                       'mimo_tpu_torch/csrc/estep.cuh',
                       'mimo_tpu/ops/pallas_estep.py:164'),
        'B1-ILR-EM': ('B1 fused E-step, ILR map, plug-in theta of the ML '
                      'params (fit_em_fused)',
                      'mimo_tpu_torch/csrc/estep.cuh',
                      'mimo_tpu/ops/pallas_estep.py:164'),
        'B1-stream': (f'B1 fused VI E-step, streamed (fit_vi_stream_full): '
                      f'one launch a {B_MAIN_STREAM}-point block of the '
                      f'staged buffer, the ragged tail at runtime n',
                      'mimo_tpu_torch/csrc/estep.cuh',
                      'mimo_tpu/ops/pallas_estep.py:164'),
        'B1-stream-sharded': (
            f'B1 fused VI E-step, streamed over a (1, 4) mesh '
            f'(fit_vi_stream_full(mesh=)): one launch a {N_SHARD_STREAM}-'
            f'point shard, a column view of the staged {B_MAIN_STREAM}-'
            f'point block', 'mimo_tpu_torch/csrc/estep.cuh',
            'mimo_tpu/ops/pallas_estep.py:164'),
        'B1-svi-stream-sharded': (
            f'B1 fused E-step of a streamed SVI step over a (1, 4) mesh '
            f'(fit_svi_stream(mesh=)): one launch a {N_SHARD_SVI}-point '
            f'shard of the staged {B_SVI_STREAM}-point minibatch',
            'mimo_tpu_torch/csrc/estep.cuh',
            'mimo_tpu/ops/pallas_estep.py:164'),
    }
    sharded = {
        'B1-sharded': ('B1', 'one shard of a (1, 4) mesh (fit_vi_fused, '
                       'fit_map_fused, fit_chains)'),
        'B2-sharded': ('B2', 'one shard of a (1, 4) mesh, the shard seed'),
        'B3-sharded': ('B3', 'one shard of a (1, 4) mesh (log_predictive)'),
        'B4-sharded': ('B4', 'one shard of a (1, 4) mesh'),
        'B5-sharded': ('B5', 'one shard of a (1, 4) mesh'),
        'B6-sharded': ('B6', 'one shard of a (1, 4) mesh, MNW'),
    }
    nested = {
        'B1-nested': ('B1', 'nested VI theta, Gauss map, M*K=32 rows'),
        'B1-nested-hier': ('B1', 'nested hierarchical VI theta, Gauss map, '
                           'M*K=32 rows'),
        'B1-nested-MAP': ('B1', 'nested plug-in theta at the posterior '
                          'mode, M*K=32 rows (fit_map_fused)'),
        'B1-nested-EM': ('B1', 'nested plug-in theta of the ML params, '
                         'M*K=32 rows (fit_em_fused)'),
        'B1-ILR-nested': ('B1', 'nested ILR VI theta, ILR map, M*K=12 rows'),
        'B2-nested': ('B2', 'nested joint M*K=32 label draw, Gauss map'),
        'B2-nested-hier': ('B2', 'nested joint M*K=32 label draw, exact '
                           'hierarchical draws'),
        'B3-nested': ('B3', 'nested NIW posterior flattened to M*K=32 rows'),
        'B3-nested-hier': ('B3', 'nested HierTied rows built per cluster, '
                           'M*K=32'),
        'B5-nested': ('B5', 'nested ILR p=1, M*K=12 flattened experts'),
        'B6-nested': ('B6', 'nested ILR p=2, M*K=8 flattened experts'),
    }
    meta.update({name: (f'{meta[base][0]}, {what}',) + meta[base][1:]
                 for name, (base, what) in nested.items()})
    meta.update({name: (f'{meta[base][0]}, {what}',) + meta[base][1:]
                 for name, (base, what) in sharded.items()})
    meta.update({name: row[:3] for name, row in wide.items()})
    meta.update({name: (f'{meta[base][0]}, chain axis: {what}',)
                       + meta[base][1:]
                 for name, (base, what) in CHAIN_ROWS.items()})
    meta.update({name: (f'{meta[name.split("-")[0]][0]}, bench.py\'s fed '
                        f'shapes: {what}',) + meta[name.split('-')[0]][1:]
                 for name, what in FED_ROWS.items()})
    rows = []
    for b in meta:
        bound_ms, bound_by, bound_op = bound(WORK[b])
        rows.append({
            'name': meta[b][0], 'route': 'cuda', 'source': meta[b][1],
            'replaces': meta[b][2], 'launches': launches[b],
            'max_abs_err': errs[b], 'ms': ms[b][0], 'plain_ms': ms[b][1],
            'bound_ms': bound_ms, 'bound_by': bound_by, 'bound_op': bound_op,
            'bound_share': bound_ms / ms[b][0],
            # one PyTorch call computes B4's, B3-diag's, B3-gauss's and
            # S3's function; none B1's, B2's, B5's or B6's, and torch has
            # no multivariate Student-t for B3's
            'library_ms': LIBRARY.get(b)})
        if b in chain_rows:     # a chain launch: C and its C one-chain
            rows[-1].update(chains=chain_rows[b][0],   # launches' time
                            singles_ms=chain_rows[b][1])
        if b in STREAM_ROWS:    # a streamed sweep: launches a sweep, tail
            rows[-1].update(STREAM_ROWS[b])
        if b in MESH_ROWS:      # one shard's launch: launches per path,
            rows[-1].update(MESH_ROWS[b])   # each shard's time, the fold
        if b in CERT_ROWS:      # a launch-bound call: its device time
            rows[-1].update(CERT_ROWS[b])
        if b in EXAMPLE_ROWS:   # the same, at a fitted state's shape
            rows[-1].update(EXAMPLE_ROWS[b])
    print(json.dumps({'kernels': rows}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))



# -- ILR -------------------------------------------------------------------


def streamed_checks(dev, gen, card, spec, n):
    """B1 and B2 in the streamed layout (csrc/tc.cuh): K=300, d=2, more
    16-row slabs than a block has warps. B1 against its plain version as
    in phase 3, bitwise on repeat; B2's labels against the plain Philox
    labels and its statistics against the one-hot sums of its labels, as
    in phase 4; each timed beside its plain version."""
    k, m8 = 300, 8
    post = random_posterior(gen, k, D_MAIN, dev)
    log_pi = torch.log_softmax(torch.randn((k,), generator=gen, device=dev), 0)
    xt = (torch.randn((D_MAIN, n), generator=gen, device=dev) * 4.0
          + post.mu[0][:, None])
    theta, _ = pad_theta(spec.theta(post), log_pi, torch.float32)
    acc, lse = cuda_estep.estep(xt, theta, n)
    acc2, lse2 = cuda_estep.estep(xt, theta, n)
    pacc, plse = cuda_estep.estep_plain(xt, theta, n)
    atol = 1e-3 * n / 1e6
    ok_s, err_s = allclose_report(acc, pacc, 1e-4, atol)
    ok_l, err_l = allclose_report(lse, plse, 1e-5, 0.0)
    bitwise = torch.equal(acc, acc2) and torch.equal(lse, lse2)
    th_g, _ = pad_theta(spec.theta_plugin(mode_params(post)), log_pi,
                        torch.float32)
    sweep_seed = torch.randint(0, 2 ** 62, (), generator=gen, device=dev)
    labels, gacc = cuda_gibbs.gibbs(xt, th_g, sweep_seed, n)
    plabels, _ = cuda_gibbs.gibbs_plain(xt, th_g, sweep_seed, n)
    f = assemble_features(xt, m8).double()
    oh = torch.nn.functional.one_hot(labels.long(), k).double()
    ok_g = bool(((gacc.double() - oh.T @ f.T).abs()
                 <= 1e-5 * (oh.T @ f.abs().T)).all())
    mismatch = float((labels != plabels).double().mean())
    t = {name: (cuda_ms(kern, 5), cuda_ms(plain, 2)) for name, kern, plain in (
        ('B1', lambda: cuda_estep.estep(xt, theta, n),
         lambda: cuda_estep.estep_plain(xt, theta, n)),
        ('B2', lambda: cuda_gibbs.gibbs(xt, th_g, sweep_seed, n),
         lambda: cuda_gibbs.gibbs_plain(xt, th_g, sweep_seed, n)))}
    print(f'streamed layout N={n} K={k} d={D_MAIN}: B1 stats max|err| '
          f'{err_s:.6g} (rtol 1e-4, atol {atol:.6g}) {"ok" if ok_s else "FAIL"}'
          f', lse |err| {err_l:.6g} (rtol 1e-5) {"ok" if ok_l else "FAIL"}, '
          f'bitwise repeat {bitwise}; B2 stats vs one-hot sums '
          f'{"ok" if ok_g else "FAIL"}, label mismatch vs plain Philox '
          f'{mismatch:.3g} (<= 1e-4); times on {card}: B1 {t["B1"][0]:.6g} '
          f'ms (plain {t["B1"][1]:.6g}), B2 {t["B2"][0]:.6g} ms (plain '
          f'{t["B2"][1]:.6g})')
    check(ok_s and ok_l and bitwise and ok_g and mismatch <= 1e-4,
          'B1 or B2 in the streamed layout disagrees')


def reset_counts():
    """Set every kernel wrapper's launch count to 0, and the K-sized
    algebra's counts."""
    for mod in (cuda_estep, cuda_gibbs, cuda_predict, cuda_ilr_predict,
                cuda_probes):
        for key in mod.launches:
            mod.launches[key] = 0
    cuda_diag_predict.launches = 0
    reset_algebra_counts()


def reset_algebra_counts():
    """Set the factorization, prior-constant and inner-round counts to 0."""
    linalg.counts.update(cholesky=0, solve=0)
    niw.prior_consts.update(built=0, reused=0)
    hierarchical.counts.update(rounds=0, updates=0)


def algebra_counts():
    """The K-sized algebra's counts since the last reset: batched
    Choleskys and Cholesky solves, prior constants built and read, the
    hierarchical updates and their inner rounds."""
    return {**linalg.counts, **niw.prior_consts, **hierarchical.counts}


def read_counts():
    return {'B1': cuda_estep.launches['gauss'],
            'B2': cuda_gibbs.launches['gauss'],
            'B3': cuda_predict.launches['gauss'],
            'B1-ILR': cuda_estep.launches['ilr'],
            'B2-ILR': cuda_gibbs.launches['ilr'],
            'B5': cuda_ilr_predict.launches['ilr_predict'],
            'B6': cuda_ilr_predict.launches['ilr_p_predict'],
            'B1-diag': cuda_estep.launches['diag'],
            'B2-diag': cuda_gibbs.launches['diag'],
            'B1-ILR-diagbasis': cuda_estep.launches['ilr_diag'],
            'B2-ILR-diagbasis': cuda_gibbs.launches['ilr_diag'],
            'B3-diag': cuda_predict.launches['diag'],
            'B4': cuda_diag_predict.launches}


def random_ilr_posterior(gen, k, d, p, dev):
    """An (NIW, MNW) posterior with the scales of a fit at N ~ 1e6:
    basis precisions ~1 per unit of x, expert noise precision ~100."""
    def psd(q):
        a = torch.randn((k, q, q), generator=gen, device=dev)
        return a @ a.transpose(-1, -2) / q + torch.eye(q, device=dev)

    def counts():
        return 1e4 + 1e4 * torch.rand((k,), generator=gen, device=dev)

    nu_b, nu_e = counts(), counts()
    basis = NIW(mu=torch.rand((k, d), generator=gen, device=dev) * 6 - 3,
                kappa=counts(), psi=psd(d) / nu_b[:, None, None], nu=nu_b)
    experts = MNW(M=torch.randn((k, p, d + 1), generator=gen,
                                device=dev) * 0.5,
                  K_=psd(d + 1) * 1e4,
                  psi=psd(p) * 100.0 / nu_e[:, None, None], nu=nu_e)
    return basis, experts


def regression_data(gen, n, d, p, dev, lo=-3.0, hi=3.0, fn=torch.sin):
    """x ~ U(lo, hi)^d, y = fn(x w) + 0.1 eps with w ~ N(0, 1)^(d x p)."""
    x = torch.rand((n, d), generator=gen, device=dev) * (hi - lo) + lo
    w = torch.randn((d, p), generator=gen, device=dev)
    return x, fn(x @ w) + 0.1 * torch.randn((n, p), generator=gen,
                                            device=dev)


def estep_magnitudes(xt, theta, n, kind=cuda_estep.GAUSS, p=0, divide=True,
                     nv=None):
    """sum_n r_nk |F_jn|: the summed magnitudes behind each entry of B1's
    statistics, the scale of their f32 rounding. r is the softmax, or
    without `divide` exp(logp - max) (S1); points at or past nv weigh
    nothing (S2)."""
    mag = torch.zeros(theta.shape, dtype=torch.float64, device=xt.device)
    end = n if nv is None else min(n, nv)
    for s in range(0, end, 1 << 20):
        f = assemble_features(xt[:, s:min(s + (1 << 20), end)],
                              theta.shape[1], kind, p)
        logp = theta @ f
        r = (torch.softmax(logp, 0) if divide
             else torch.exp(logp - logp.max(0).values))
        mag += (r @ f.abs().T).double()
    return mag


def compare_serving(out, ref, p, hard):
    """(ok, max |err| over points that pick the same expert, points that
    disagree) for B5/B6 rows [mean (p), var (p), nlpd, lse_w] under the
    tolerances of tests/test_pallas.py (mean rtol 1e-4 / atol 1e-4, var
    rtol 2e-3 / atol 1e-5, NLPD rtol 1e-3 / atol 2e-3) and lse_w rtol
    1e-5 / atol 1e-4. With prediction='mode' a point whose two best
    experts are tied to f32 rounding may pick either; at most 1e-5 of the
    points may."""
    tol = ([(1e-4, 1e-4)] * p + [(2e-3, 1e-5)] * p + [(1e-3, 2e-3)]
           + [(1e-5, 1e-4)])
    bad = torch.zeros(out.shape[1], dtype=torch.bool, device=out.device)
    worst = 0.0
    for row, (rtol, atol) in enumerate(tol):
        err = (out[row].double() - ref[row].double()).abs()
        bad |= err > atol + rtol * ref[row].double().abs()
        worst = max(worst, float(err.max()))
    flips = int(bad.sum())
    if hard and flips:
        worst = max(float((out[r].double() - ref[r].double())[~bad].abs()
                          .max()) for r in range(out.shape[0]))
    ok = (flips <= 1e-5 * out.shape[1]) if hard else flips == 0
    return ok and bool(torch.isfinite(out).all()), worst, flips


def ilr_kernel_checks(dev, gen, card, errs):
    """B1/B2 over the ILR map, B5 and B6 against their plain versions."""
    errs['B1-ILR'] = errs['B2-ILR'] = errs['B5'] = errs['B6'] = 0.0
    for n, k, d, p in ((N_CHECK, K_MAIN, D_Q8, 1), (1000, 7, 2, 3)):
        post = random_ilr_posterior(gen, k, d, p, dev)
        spec = ilr_spec(d, p)
        log_pi = torch.log_softmax(torch.randn((k,), generator=gen,
                                               device=dev), 0)
        xt = stack_rows(kernel_xts(regression_data(gen, n, d, p, dev)))
        theta, _ = pad_theta(spec.theta(post), log_pi, torch.float32)
        acc, lse = cuda_estep.estep(xt, theta, n, ILR, p)
        acc2, lse2 = cuda_estep.estep(xt, theta, n, ILR, p)
        pacc, plse = cuda_estep.estep_plain(xt, theta, n, ILR, p)
        mag = estep_magnitudes(xt, theta, n, ILR, p)
        torch.cuda.synchronize()
        err = (acc.double() - pacc.double()).abs()
        ok_s = bool((err <= 1e-5 * mag + 1e-6).all())
        ok_l, err_l = allclose_report(lse, plse, 1e-5, 0.0)
        bitwise = torch.equal(acc, acc2) and torch.equal(lse, lse2)
        print(f'B1-ILR N={n} K={k} d={d} p={p} m8={theta.shape[1]}: stats '
              f'max|err| {float(err.max()):.6g}, max |err| / summed '
              f'magnitude {float((err / mag.clamp(min=1e-30)).max()):.3g} '
              f'(<= 1e-5) {"ok" if ok_s else "FAIL"}; lse '
              f'{float(lse):.9g} vs {float(plse):.9g}, |err| {err_l:.6g} '
              f'(rtol 1e-5) {"ok" if ok_l else "FAIL"}; bitwise repeat '
              f'{bitwise}')
        check(ok_s and ok_l and bitwise and bool(torch.isfinite(acc).all()),
              f'B1-ILR disagrees at N={n}')
        errs['B1-ILR'] = max(errs['B1-ILR'], float(err.max()))

        th_g, _ = pad_theta(spec.theta_plugin(ilr_family().mode_params(post)),
                            log_pi, torch.float32)
        sweep_seed = torch.randint(0, 2 ** 62, (), generator=gen, device=dev)
        labels, acc = cuda_gibbs.gibbs(xt, th_g, sweep_seed, n, ILR, p)
        plabels, _ = cuda_gibbs.gibbs_plain(xt, th_g, sweep_seed, n, ILR, p)
        f = assemble_features(xt, th_g.shape[1], ILR, p).double()
        oh = torch.nn.functional.one_hot(labels.long(), k).double()
        err = (acc.double() - oh.T @ f.T).abs()
        ok_acc = bool((err <= 1e-5 * (oh.T @ f.abs().T) + 1e-6).all())
        in_range = int(labels.min()) >= 0 and int(labels.max()) < k
        mismatch = float((labels != plabels).double().mean())
        print(f'B2-ILR N={n} K={k} d={d} p={p}: labels in [0, {k}) '
              f'{in_range}, {int(torch.unique(labels).numel())} used; stats '
              f'vs one-hot sums of its labels max|err| {float(err.max()):.6g}'
              f' (<= 1e-5 x summed magnitudes) {"ok" if ok_acc else "FAIL"};'
              f' label mismatch vs plain Philox {mismatch:.3g} (<= 1e-4)')
        check(in_range and ok_acc and mismatch <= 1e-4, 'B2-ILR disagrees')
        errs['B2-ILR'] = max(errs['B2-ILR'], float(err.max()))
        del f, oh

    for name, d, p in (('B5', 1, 1), ('B6', D_P3, P_P3)):
        basis, experts = random_ilr_posterior(gen, K_MAIN, d, p, dev)
        log_w = torch.log_softmax(torch.randn((K_MAIN,), generator=gen,
                                              device=dev), 0)
        x, y = regression_data(gen, N_CHECK, d, p, dev)
        for has_y in (True, False):
            xt = stack_rows(kernel_xts((x, y) if has_y else (x,)))
            for hard in (False, True):
                if p == 1:
                    th, aux = cuda_ilr_predict.ilr_predict_coefficients(
                        basis, experts, log_w)
                    out = cuda_ilr_predict.ilr_predict(xt, th, aux, N_CHECK,
                                                       has_y, hard)
                    ref = cuda_ilr_predict.ilr_predict_plain(
                        xt, th, aux, N_CHECK, has_y, hard)
                else:
                    th, aux, vc = cuda_ilr_predict.ilr_p_predict_coefficients(
                        basis, experts, log_w, True, has_y)
                    out = cuda_ilr_predict.ilr_p_predict(
                        xt, th, aux, vc, N_CHECK, p, has_y, hard)
                    ref = cuda_ilr_predict.ilr_p_predict_plain(
                        xt, th, aux, vc, N_CHECK, p, has_y, hard)
                torch.cuda.synchronize()
                ok, worst, flips = compare_serving(out, ref, p, hard)
                print(f'{name} N={N_CHECK} K={K_MAIN} d={d} p={p} '
                      f'{"mode" if hard else "average"} '
                      f'{"with" if has_y else "without"} y: max|err| '
                      f'{worst:.6g} (mean rtol/atol 1e-4, var 2e-3/1e-5, '
                      f'nlpd 1e-3/2e-3, lse_w 1e-5/1e-4); points off '
                      f'{flips} {"ok" if ok else "FAIL"}')
                check(ok, f'{name} disagrees')
                errs[name] = max(errs[name], worst)


def engines_vs_plain(model, st, x, y):
    """The ILR engines' kernel path against their plain path on the
    first 100,003 points: 5 warm VI sweeps (ELBO rtol 1e-4) and predict
    (the serving tolerances, in original units)."""
    xs, ys = x[:100_003], y[:100_003]
    _, v_k = model.fit_vi_fused((xs, ys), maxiter=5, init_state=st,
                                randomize=False, backend='kernel')
    _, v_t = model.fit_vi_fused((xs, ys), maxiter=5, init_state=st,
                                randomize=False, backend='torch')
    ok_v, e_v = allclose_report(v_k, v_t, 1e-4, 0.0)
    got = model.predict(st, xs, ys, backend='kernel')
    want = model.predict(st, xs, ys, backend='torch')
    scale = float(model.output_transform.scale.max()
                  if model.output_transform is not None else 1.0)
    oks, errs_ = [], []
    for g, w, (rtol, atol) in zip(
            (got[0], got[1], got[3]), (want[0], want[1], want[3]),
            ((1e-4, 1e-4 * scale), (2e-3, 1e-4 * scale ** 2),
             (1e-3, 2e-3))):
        ok, e = allclose_report(g, w, rtol, atol)
        oks.append(ok)
        errs_.append(e)
    rmse = float(torch.sqrt(torch.mean((got[0] - ys) ** 2)))
    print(f'  vs plain on 100,003 points: VI ELBO max|err| {e_v:.6g} (rtol '
          f'1e-4) {"ok" if ok_v else "FAIL"}; predict mean/var/nlpd '
          f'max|err| {errs_[0]:.6g}/{errs_[1]:.6g}/{errs_[2]:.6g} '
          f'{"ok" if all(oks) else "FAIL"}; RMSE there {rmse:.6g}')
    check(ok_v and all(oks), 'ILR kernel path disagrees with the plain path')


def elbo_report(tag, vlb, what='ELBO'):
    v = vlb.double()
    rel_drop = float(((v[:-1] - v[1:]) / v[1:].abs()).max())
    print(f'{tag}: {what} {float(v[0]):.9g} -> {float(v[-1]):.9g}, worst '
          f'relative drop {rel_drop:.3g} (<= 1e-4)')
    check(bool(torch.isfinite(v).all()) and rel_drop <= 1e-4,
          f'{tag}: {what} not finite or decreasing')


def ilr_fit_path(dev, seed, card, errs, launches, ms):
    """The q8 fit path of bench.py:313-336 on the port."""
    kg = torch.Generator(device=dev).manual_seed(seed + 3)
    x, y = regression_data(kg, N_Q8, D_Q8, 1, dev)
    model = BayesianILR.make(size=K_MAIN, input_dim=D_Q8, output_dim=1,
                             alpha=2.0, kappa=0.05, device=dev)
    torch.cuda.synchronize()
    reset_counts()
    # the flagship's order: Gibbs from the prior, then VI warm-started
    # from its state (from random responsibilities 20 VI sweeps leave the
    # experts at the symmetric start and the cancelling MNW update idle)
    gs = model.fit_gibbs_fused((x, y), key=2, maxiter=20)
    st, vlb = model.fit_vi_fused((x, y), key=1, maxiter=20,
                                 init_state=MFState(gs.components, gs.gating),
                                 randomize=False)
    torch.cuda.synchronize()
    path = read_counts()
    launches.update({b: path[b] for b in ('B1-ILR', 'B2-ILR')})
    tag = f'ILR fit N={N_Q8} K={K_MAIN} d={D_Q8} p=1'
    print(f'{tag}: launches {path}')
    check(path['B1-ILR'] == 20 and path['B2-ILR'] == 20,
          'the ILR fit path bypassed a kernel')
    elbo_report(f'{tag} VI', vlb)
    check(all_finite(st) and all_finite(gs[:4])
          and gs.labels.shape == (N_Q8,) and int(gs.labels.min()) >= 0
          and int(gs.labels.max()) < K_MAIN,
          'ILR state not finite or labels out of range')
    w_vi = st.gating.mean()
    counts = torch.bincount(gs.labels.long(), minlength=K_MAIN)
    noise = st.components[1].nu * st.components[1].psi[:, 0, 0]  # E[lambda]
    print(f'{tag}: VI top-3 weights '
          f'{[round(float(w), 4) for w in torch.sort(w_vi)[0][-3:]]}; Gibbs '
          f'components with >= 1% of points '
          f'{int((counts >= 0.01 * N_Q8).sum())}; expert noise precision '
          f'E[lambda] {float(noise.min()):.4g}-{float(noise.max()):.4g} '
          f'(100 at the noise floor)')
    engines_vs_plain(model, st, x, y)

    vi = rate(20, lambda: model.fit_vi_fused((x, y), maxiter=20,
                                             init_state=st, randomize=False))
    gibbs = rate(20, lambda: model.fit_gibbs_fused((x, y), key=3,
                                                   maxiter=20))
    print(f'rates on {card}, {tag}: VI {vi} it/s (20 warm-started sweeps); '
          f'Gibbs {gibbs} sweeps/s (20 sweeps)')

    spec = model._estep_spec()
    xt = stack_rows(kernel_xts((x, y)))
    th_vi, _ = pad_theta(spec.theta(st.components),
                         st.gating.expected_log_pi(), torch.float32)
    th_g, _ = pad_theta(spec.theta_plugin(gs.params), gs.log_pi,
                        torch.float32)
    sweep_seed = torch.zeros((), dtype=torch.int64, device=dev)
    pairs = {
        'B1-ILR': (lambda: cuda_estep.estep(xt, th_vi, N_Q8, ILR, 1),
                   lambda: cuda_estep.estep_plain(xt, th_vi, N_Q8, ILR, 1)),
        'B2-ILR': (lambda: cuda_gibbs.gibbs(xt, th_g, sweep_seed, N_Q8, ILR,
                                            1),
                   lambda: cuda_gibbs.gibbs_plain(xt, th_g, sweep_seed, N_Q8,
                                                  ILR, 1)),
    }
    m = cuda_estep.feature_width(ILR, D_Q8, 1)
    WORK.update({'B1-ILR': estep_work(N_Q8, K_MAIN, m, D_Q8 + 1),
                 'B2-ILR': gibbs_work(xt, th_g, N_Q8, m, ILR, 1)})
    for name, (kern, plain) in pairs.items():
        ms[name] = (cuda_ms(kern, 20), cuda_ms(plain, 3))
        print(f'{name} time on {card} at N={N_Q8} K={K_MAIN} d={D_Q8} p=1 '
              f'm8={th_vi.shape[1]}: kernel {ms[name][0]:.6g} ms, plain '
              f'PyTorch {ms[name][1]:.6g} ms')
    precision_check(f'q8 N={N_Q8} K={K_MAIN} d={D_Q8} p=1 m8=168', xt, th_vi,
                    N_Q8, ILR, 1)


def ilr_serving_paths(dev, seed, card, launches, ms, diag=False):
    """The sine flagship (bench.py:338-356) through B5 and p>1 serving
    (the shape of tests/test_pallas.py:445 at K=50) through B6; with
    `diag`, the same paths with MNG experts through B5's MNG rows and
    B6's MNG tail."""
    suffix = '-MNG' if diag else ''
    for count, n, d, p in (('B5', N_SINE, 1, 1), ('B6', N_P3, D_P3, P_P3)):
        name = count + suffix
        kg = torch.Generator(device=dev).manual_seed(seed + 5)
        if p == 1:
            x = torch.rand((n, 1), generator=kg, device=dev) * 12 - 6
            y = torch.sin(x) + 0.1 * torch.randn((n, 1), generator=kg,
                                                 device=dev)
        else:
            x, y = regression_data(kg, n, d, p, dev, fn=torch.tanh)
        model = BayesianILR.make(size=K_MAIN, input_dim=d, output_dim=p,
                                 alpha=2.0, kappa=0.05 if p == 1 else 0.1,
                                 diag=diag, device=dev)
        model.init_transform(x, y)
        torch.cuda.synchronize()
        reset_counts()
        if p == 1:      # the flagship's Gibbs-then-VI order
            g = model.fit_gibbs_fused((x, y), key=0, maxiter=10)
            st, vlb = model.fit_vi_fused(
                (x, y), key=1, maxiter=20,
                init_state=MFState(g.components, g.gating), randomize=False)
        else:
            st, vlb = model.fit_vi_fused((x, y), key=1, maxiter=20)
        mu, var, _, nlpd = model.predict(st, x, y)
        torch.cuda.synchronize()
        path = read_counts()
        launches[name] = path[count]
        tag = (f'ILR serving ({"sine" if p == 1 else "tanh"}'
               f'{", MNG experts" if diag else ""}) N={n} K={K_MAIN} d={d} '
               f'p={p}')
        print(f'{tag}: launches {path}')
        check(path[count] >= 1 and path['B1-ILR'] == 20
              and path['B2-ILR'] == (10 if p == 1 else 0),
              'the ILR serving path bypassed a kernel')
        check(isinstance(st.components[1], MNG) == diag,
              'the ILR serving path fitted the wrong experts')
        elbo_report(f'{tag} VI', vlb)
        rmse = float(torch.sqrt(torch.mean((mu - y) ** 2)))
        print(f'{tag}: RMSE {rmse:.6g} (noise floor 0.1), mean NLPD '
              f'{float(nlpd.mean()):.6g} nats, original units')
        check(mu.shape == (n, p) and var.shape == (n, p)
              and nlpd.shape == (n,) and math.isfinite(rmse)
              and all_finite((mu, var, nlpd)),
              'ILR predict not finite or of the wrong shape')
        engines_vs_plain(model, st, x, y)

        pred = rate(n, lambda: model.predict(st, x, y))
        print(f'rates on {card}, {tag}: predict {pred} pts/s (weights, '
              f'moments and NLPD, original units)')
        basis, experts = st.components
        log_w = model.predictive_log_weights(st)
        xt = stack_rows(kernel_xts((model._tx(x), model._ty(y))))
        if p == 1:
            th, aux = cuda_ilr_predict.ilr_predict_coefficients(
                basis, experts, log_w)
            kern = lambda: cuda_ilr_predict.ilr_predict(  # noqa: E731
                xt, th, aux, n, True, False)
            plain = lambda: cuda_ilr_predict.ilr_predict_plain(  # noqa: E731
                xt, th, aux, n, True, False)
        else:
            th, aux, vc = cuda_ilr_predict.ilr_p_predict_coefficients(
                basis, experts, log_w)
            kern = lambda: cuda_ilr_predict.ilr_p_predict(  # noqa: E731
                xt, th, aux, vc, n, p, True, False)
            plain = lambda: cuda_ilr_predict.ilr_p_predict_plain(  # noqa: E731
                xt, th, aux, vc, n, p, True, False)
        WORK[name] = serving_work(n, K_MAIN, d, p, diag)
        ms[name] = (cuda_ms(kern, 20), cuda_ms(plain, 3))
        print(f'{name} time on {card} at N={n} K={K_MAIN} d={d} p={p} '
              f'm8={th.shape[1]}: kernel {ms[name][0]:.6g} ms, plain '
              f'PyTorch {ms[name][1]:.6g} ms')
        moments = [('rel', f'mean{j}' if p > 1 else 'mean') for j in range(p)]
        moments += [('rel', f'var{j}' if p > 1 else 'var') for j in range(p)]
        rows = moments + [('nats', 'nlpd'), ('nats', 'lse_w')]
        if p == 1:
            serving_precision_cells(
                name, cuda_ilr_predict.ilr_predict,
                cuda_ilr_predict.ilr_predict_plain, xt, th,
                (aux, n, True, False), rows, d, slice(0, K_MAIN))
        else:
            serving_precision_cells(
                name, cuda_ilr_predict.ilr_p_predict,
                cuda_ilr_predict.ilr_p_predict_plain, xt, th,
                (aux, vc, n, p, True, False), rows, d, slice(0, K_MAIN), p=p)
        del x, y, model, st, mu, var, nlpd, xt
        torch.cuda.empty_cache()


# -- the diagonal families --------------------------------------------------


def random_ng_posterior(gen, k, d, dev, shared=True):
    """An NG posterior with the scales of a fit at N ~ 1e6: ~1e4-1e5
    points per component, variances 0.25-0.75 per dimension. As in a fit
    the counts (so kappa, alpha and the tail exponents h) are the same in
    every dim of a component (the first dim's draw); shared=False keeps
    the draw of each dim."""
    def u(lo, hi):
        return lo + (hi - lo) * torch.rand((k, d), generator=gen, device=dev)
    counts = u(1e4, 1e5)
    if shared:
        counts = counts[:, :1].expand(k, d).contiguous()
    return NG(mu=torch.randn((k, d), generator=gen, device=dev) * 4.0,
              kappa=counts, alpha=0.5 * counts,
              beta=0.5 * counts * u(0.25, 0.75))


def random_mng_posterior(gen, k, d, p, dev):
    """An (NIW, MNG) posterior with the scales of random_ilr_posterior:
    per-output noise precision ~100."""
    basis, experts = random_ilr_posterior(gen, k, d, p, dev)
    alpha = 0.5 * (1e4 + 1e4 * torch.rand((k, p), generator=gen, device=dev))
    beta = alpha / (100.0 * (0.5 + torch.rand((k, p), generator=gen,
                                              device=dev)))
    return basis, MNG(M=experts.M, K_=experts.K_, alpha=alpha, beta=beta)


def diag_kernel_checks(dev, gen, errs):
    """B1/B2 over the diagonal map, B3 over it, B4, and B5/B6 with MNG
    experts against their plain versions."""
    spec = diag_gaussian_spec()
    errs['B1-diag'] = errs['B2-diag'] = 0.0
    for n, k, d in ((N_CHECK, K_MAIN, D_MAIN), (1000, 7, 3)):
        post = random_ng_posterior(gen, k, d, dev)
        log_pi = torch.log_softmax(torch.randn((k,), generator=gen,
                                               device=dev), 0)
        xt = (torch.randn((d, n), generator=gen, device=dev) * 4.0
              + post.mu[0][:, None])
        theta, _ = pad_theta(spec.theta(post), log_pi, torch.float32)
        acc, lse = cuda_estep.estep(xt, theta, n, DIAG)
        acc2, lse2 = cuda_estep.estep(xt, theta, n, DIAG)
        pacc, plse = cuda_estep.estep_plain(xt, theta, n, DIAG)
        torch.cuda.synchronize()
        atol = 1e-3 * n / 1e6
        ok_s, err_s = allclose_report(acc, pacc, 1e-4, atol)
        ok_l, err_l = allclose_report(lse, plse, 1e-5, 0.0)
        bitwise = torch.equal(acc, acc2) and torch.equal(lse, lse2)
        print(f'B1-diag N={n} K={k} d={d} m8={theta.shape[1]}: stats '
              f'max|err| {err_s:.6g} (rtol 1e-4, atol {atol:.6g}) '
              f'{"ok" if ok_s else "FAIL"}; lse {float(lse):.9g} vs '
              f'{float(plse):.9g}, |err| {err_l:.6g} (rtol 1e-5) '
              f'{"ok" if ok_l else "FAIL"}; bitwise repeat {bitwise}')
        check(ok_s and ok_l and bitwise and bool(torch.isfinite(acc).all()),
              f'B1-diag disagrees at N={n}')
        errs['B1-diag'] = max(errs['B1-diag'], err_s)

        th_g, _ = pad_theta(spec.theta_plugin(ng.mode_params(post)), log_pi,
                            torch.float32)
        sweep_seed = torch.randint(0, 2 ** 62, (), generator=gen, device=dev)
        labels, acc = cuda_gibbs.gibbs(xt, th_g, sweep_seed, n, DIAG)
        plabels, _ = cuda_gibbs.gibbs_plain(xt, th_g, sweep_seed, n, DIAG)
        f = assemble_features(xt, th_g.shape[1], DIAG).double()
        oh = torch.nn.functional.one_hot(labels.long(), k).double()
        err = (acc.double() - oh.T @ f.T).abs()
        ok_acc = bool((err <= 1e-5 * (oh.T @ f.abs().T) + 1e-6).all())
        in_range = int(labels.min()) >= 0 and int(labels.max()) < k
        mismatch = int((labels != plabels).sum())
        print(f'B2-diag N={n} K={k} d={d}: labels in [0, {k}) {in_range}, '
              f'{int(torch.unique(labels).numel())} used; stats vs one-hot '
              f'sums of its labels max|err| {float(err.max()):.6g} (<= 1e-5 '
              f'x summed magnitudes) {"ok" if ok_acc else "FAIL"}; points '
              f'whose label differs from the plain Philox label {mismatch} '
              f'(<= 1e-4 of {n})')
        check(in_range and ok_acc and mismatch <= 1e-4 * n,
              'B2-diag disagrees')
        errs['B2-diag'] = max(errs['B2-diag'], float(err.max()))
        if d == D_MAIN:
            b4_post, b4_xt = post, xt

    # B3 over the diagonal map (Gaussian) and B4 (Student-t), h shared
    # across dims (as in a fit) and not
    log_w = torch.log_softmax(torch.randn((K_MAIN,), generator=gen,
                                          device=dev), 0)
    thq, aux = cuda_predict.diag_gaussian_coefficients(b4_post, log_w)
    rows4, aux4 = cuda_diag_predict.diag_predict_coefficients(b4_post, log_w)
    # its own generator, so that the later phases draw what they drew
    # before this check existed
    post_u = random_ng_posterior(
        torch.Generator(device=dev).manual_seed(gen.initial_seed() + 1),
        K_MAIN, D_MAIN, dev, shared=False)
    rows_u, aux_u = cuda_diag_predict.diag_predict_coefficients(post_u, log_w)
    check(bool((aux4[:, 1] > 0).all()) and not bool((aux_u[:, 1] > 0).any()),
          'B4 h-shared flags off')
    for name, kern, plain in (
            ('B3-diag',
             lambda: cuda_predict.predict(b4_xt, thq, aux, N_CHECK, False,
                                          DIAG),
             lambda: cuda_predict.predict_plain(b4_xt, thq, aux, N_CHECK,
                                                False, DIAG)),
            ('B4',
             lambda: cuda_diag_predict.diag_predict(b4_xt, rows4, aux4,
                                                    N_CHECK),
             lambda: cuda_diag_predict.diag_predict_plain(b4_xt, rows4, aux4,
                                                          N_CHECK)),
            ('B4 (unequal h)',
             lambda: cuda_diag_predict.diag_predict(b4_xt, rows_u, aux_u,
                                                    N_CHECK),
             lambda: cuda_diag_predict.diag_predict_plain(b4_xt, rows_u,
                                                          aux_u, N_CHECK))):
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        ok, e = allclose_report(out, ref, 1e-4, 1e-4)
        errs[name] = e
        print(f'{name} N={N_CHECK} K={K_MAIN} d={D_MAIN}: max|err| {e:.6g} '
              f'nats (rtol 1e-4, atol 1e-4) {"ok" if ok else "FAIL"}; finite '
              f'{bool(torch.isfinite(out).all())}; log-density '
              f'{float(out.min()):.6g} to {float(out.max()):.6g}')
        check(ok and bool(torch.isfinite(out).all()), f'{name} disagrees')
    errs['B4'] = max(errs['B4'], errs.pop('B4 (unequal h)'))
    mu_u, lam_u, _ = ng.predictive_studentt_params(post_u)
    serving_precision_cells(
        'B4-unequal-h', cuda_diag_predict.diag_predict,
        cuda_diag_predict.diag_predict_plain, b4_xt, rows_u, (aux_u, N_CHECK),
        (('nats', 'log density'),), D_MAIN, None,
        centres=(mu_u.double(), lam_u.double().min(-1).values ** -0.5),
        translate=translate_b4_rows)

    for name, d, p in (('B5-MNG', 1, 1), ('B6-MNG', D_P3, P_P3)):
        basis, experts = random_mng_posterior(gen, K_MAIN, d, p, dev)
        log_w = torch.log_softmax(torch.randn((K_MAIN,), generator=gen,
                                              device=dev), 0)
        x, y = regression_data(gen, N_CHECK, d, p, dev)
        errs[name] = 0.0
        for has_y in (True, False):
            xt = stack_rows(kernel_xts((x, y) if has_y else (x,)))
            for hard in (False, True):
                if p == 1:
                    th, aux = cuda_ilr_predict.ilr_predict_coefficients(
                        basis, experts, log_w)
                    out = cuda_ilr_predict.ilr_predict(xt, th, aux, N_CHECK,
                                                       has_y, hard)
                    ref = cuda_ilr_predict.ilr_predict_plain(
                        xt, th, aux, N_CHECK, has_y, hard)
                else:
                    th, aux, vc = cuda_ilr_predict.ilr_p_predict_coefficients(
                        basis, experts, log_w, True, has_y)
                    check(vc.shape == (K_MAIN, 2 * p),
                          'B6-MNG coefficients lack the tail exponents')
                    out = cuda_ilr_predict.ilr_p_predict(
                        xt, th, aux, vc, N_CHECK, p, has_y, hard)
                    ref = cuda_ilr_predict.ilr_p_predict_plain(
                        xt, th, aux, vc, N_CHECK, p, has_y, hard)
                torch.cuda.synchronize()
                ok, worst, flips = compare_serving(out, ref, p, hard)
                print(f'{name} N={N_CHECK} K={K_MAIN} d={d} p={p} rows '
                      f'{th.shape[0]} {"mode" if hard else "average"} '
                      f'{"with" if has_y else "without"} y: max|err| '
                      f'{worst:.6g} (mean rtol/atol 1e-4, var 2e-3/1e-5, '
                      f'nlpd 1e-3/2e-3, lse_w 1e-5/1e-4); points off '
                      f'{flips} {"ok" if ok else "FAIL"}')
                check(ok, f'{name} disagrees')
                errs[name] = max(errs[name], worst)


def diag_gmm_path(dev, seed, card, n_main, errs, launches, ms):
    """The diagonal GMM of bench.py:168-188 on the data of
    bench.py:90-98: NG components, the default Dirichlet gating."""
    kg = torch.Generator(device=dev).manual_seed(seed)
    mu = torch.randn((3, D_MAIN), generator=kg, device=dev) * 4.0
    lm = torch.eye(D_MAIN, device=dev).expand(3, D_MAIN, D_MAIN) * 2.0
    x, _ = BayesianGMM.generate(kg, GaussParams(mu, lm), [.3, .4, .3],
                                n_main)
    model = BayesianGMM.make(size=K_MAIN, dim=D_MAIN, diag=True, kappa=0.05,
                             device=dev)
    torch.cuda.synchronize()
    reset_counts()
    st, vlb = model.fit_vi_fused(x, key=1, maxiter=20)
    gs = model.fit_gibbs_fused(x, key=2, maxiter=20)
    lp_t = model.log_predictive(st, x)
    lp_g = model.log_predictive(st, x, dist='gaussian')
    torch.cuda.synchronize()
    path = read_counts()
    names = ('B1-diag', 'B2-diag', 'B3-diag', 'B4')
    launches.update({b: path[b] for b in names})
    tag = f'diag GMM N={n_main} K={K_MAIN} d={D_MAIN}'
    print(f'{tag}: launches {path}')
    check(path['B1-diag'] == 20 and path['B2-diag'] == 20
          and path['B3-diag'] >= 1 and path['B4'] >= 1,
          'the diagonal GMM path bypassed a kernel')
    check(isinstance(st.components, NG), 'the diagonal GMM is not NG')
    elbo_report(f'{tag} VI', vlb)
    check(all_finite(st) and all_finite(gs[:4])
          and gs.labels.shape == (n_main,) and int(gs.labels.min()) >= 0
          and int(gs.labels.max()) < K_MAIN,
          'diagonal GMM state not finite or labels out of range')
    # NG's uncentered beta update (s2 + kappa m^2 - kappa' m'^2) in f32
    beta_vi, beta_g = (float(st.components.beta.min()),
                       float(gs.components.beta.min()))
    print(f'{tag}: smallest posterior beta VI {beta_vi:.6g}, Gibbs '
          f'{beta_g:.6g} (must be > 0)')
    check(beta_vi > 0 and beta_g > 0, 'NG beta update lost its sign')
    check(lp_t.shape == (n_main,) and all_finite((lp_t, lp_g)),
          'diagonal log_predictive not finite')
    w_vi = st.gating.mean()
    counts = torch.bincount(gs.labels.long(), minlength=K_MAIN)
    big = torch.nonzero(counts >= 0.2 * n_main)[:, 0]
    near = torch.cdist(mu, gs.components.mu[big]).min(1).values
    print(f'{tag}: VI top-3 weights '
          f'{[round(float(w), 4) for w in torch.sort(w_vi)[0][-3:]]}; '
          f'Gibbs components with >= 20% of points {len(big)}, true means '
          f'within {float(near.max()):.4g} of them; mean log predictive '
          f'Student-t {float(lp_t.mean()):.6g}, Gaussian '
          f'{float(lp_g.mean()):.6g}')

    xs_ = x[:100_003]
    _, v_k = model.fit_vi_fused(xs_, maxiter=5, init_state=st,
                                randomize=False, backend='kernel')
    _, v_t = model.fit_vi_fused(xs_, maxiter=5, init_state=st,
                                randomize=False, backend='torch')
    ok_v, e_v = allclose_report(v_k, v_t, 1e-4, 0.0)
    oks, msg = [ok_v], f'VI ELBO max|err| {e_v:.6g} (rtol 1e-4)'
    for dist in ('studentt', 'gaussian'):
        ok, e = allclose_report(
            model.log_predictive(st, xs_, dist=dist, backend='kernel'),
            model.log_predictive(st, xs_, dist=dist, backend='torch'),
            1e-4, 1e-4)
        oks.append(ok)
        msg += f'; log_predictive {dist} max|err| {e:.6g} (rtol/atol 1e-4)'
    print(f'{tag} vs plain on 100,003 points: {msg} '
          f'{"ok" if all(oks) else "FAIL"}')
    check(all(oks), 'diagonal kernel path disagrees with the plain path')

    vi = rate(20, lambda: model.fit_vi_fused(x, maxiter=20, init_state=st,
                                             randomize=False))
    gibbs = rate(20, lambda: model.fit_gibbs_fused(x, key=3, maxiter=20))
    pred_t = rate(n_main, lambda: model.log_predictive(st, x))
    pred_g = rate(n_main, lambda: model.log_predictive(st, x,
                                                       dist='gaussian'))
    print(f'rates on {card}, {tag}: VI {vi} it/s (20 warm-started sweeps); '
          f'Gibbs {gibbs} sweeps/s (20 sweeps); predictive Student-t '
          f'{pred_t} pts/s, Gaussian {pred_g} pts/s')

    spec = diag_gaussian_spec()
    xt = kernel_xts((x,))[0]
    th_vi, _ = pad_theta(spec.theta(st.components),
                         st.gating.expected_log_pi(), torch.float32)
    th_g, _ = pad_theta(spec.theta_plugin(gs.params), gs.log_pi,
                        torch.float32)
    log_w = model.predictive_log_weights(st)
    thq, aux = cuda_predict.diag_gaussian_coefficients(st.components, log_w)
    rows4, aux4 = cuda_diag_predict.diag_predict_coefficients(
        st.components, log_w)
    sweep_seed = torch.zeros((), dtype=torch.int64, device=dev)
    pairs = {
        'B1-diag': (lambda: cuda_estep.estep(xt, th_vi, n_main, DIAG),
                    lambda: cuda_estep.estep_plain(xt, th_vi, n_main, DIAG)),
        'B2-diag': (lambda: cuda_gibbs.gibbs(xt, th_g, sweep_seed, n_main,
                                             DIAG),
                    lambda: cuda_gibbs.gibbs_plain(xt, th_g, sweep_seed,
                                                   n_main, DIAG)),
        'B3-diag': (lambda: cuda_predict.predict(xt, thq, aux, n_main, False,
                                                 DIAG),
                    lambda: cuda_predict.predict_plain(xt, thq, aux, n_main,
                                                       False, DIAG)),
        'B4': (lambda: cuda_diag_predict.diag_predict(xt, rows4, aux4,
                                                      n_main),
               lambda: cuda_diag_predict.diag_predict_plain(xt, rows4, aux4,
                                                            n_main)),
    }
    m = cuda_estep.feature_width(DIAG, D_MAIN)
    WORK.update({'B1-diag': estep_work(n_main, K_MAIN, m, D_MAIN),
                 'B2-diag': gibbs_work(xt, th_g, n_main, m, DIAG),
                 'B3-diag': density_work(
                     n_main, K_MAIN, quad_fmas(D_MAIN, True), D_MAIN, 1,
                     products=point_products(D_MAIN, True)),
                 'B4': b4_work(n_main, D_MAIN, aux4)})
    for name, (kern, plain) in pairs.items():
        ms[name] = (cuda_ms(kern, 20), cuda_ms(plain, 3))
        print(f'{name} time on {card} at N={n_main} K={K_MAIN} d={D_MAIN}: '
              f'kernel {ms[name][0]:.6g} ms, plain PyTorch {ms[name][1]:.6g}'
              f' ms')
    time_library(card, tag, st.components, log_w, x,
                 {name: pairs[name] for name in ('B3-diag', 'B4')})
    precision_check(f'diag N={n_main} K={K_MAIN} d={D_MAIN}', xt, th_vi,
                    n_main, DIAG)
    mu_t, lam_t, _ = ng.predictive_studentt_params(st.components)
    serving_precision_cells(
        'B4', cuda_diag_predict.diag_predict,
        cuda_diag_predict.diag_predict_plain, xt, rows4, (aux4, n_main),
        (('nats', 'log density'),), D_MAIN, None,
        centres=(mu_t.double(), lam_t.double().min(-1).values ** -0.5),
        translate=translate_b4_rows)
    del x, xt, model, st, gs, lp_t, lp_g
    torch.cuda.empty_cache()


# -- the tied and hierarchical families ---------------------------------------


def hier_from(post):
    """A HierTied posterior with an NIW posterior's scales: its first
    component's NW as the hyper-posterior, its means and kappas as the
    q(mu_k)."""
    return HierTied(hyper=NIW(*(t[:1] for t in post)), mus=post.mu,
                    kappas=post.kappa, kappas0=torch.ones_like(post.kappa))


def tied_from(experts):
    """Tied-affine experts with an MNW posterior's scales: expert 0's
    slope, column precision and noise, every expert's offset and offset
    precision, 0-d nu."""
    d = experts.M.shape[-1] - 1
    return TiedAffine(M=experts.M[0, :, :d], K_=experts.K_[0, :d, :d],
                      mus=experts.M[:, :, d], kappas=experts.K_[:, d, d],
                      psi=experts.psi[0], nu=experts.nu[0])


def hier_update_choleskys(model, x, labels):
    """The batched Choleskys of one hierarchical update (the model's
    family update, its maxsubiter rounds) on the statistics of `labels`."""
    k, d = model.size, x.shape[1]
    z = labels.long()
    n1 = torch.bincount(z, minlength=k).to(x.dtype)
    sx = torch.zeros((k, d), dtype=x.dtype, device=x.device).index_add_(
        0, z, x)
    xxT = torch.zeros((k, d, d), dtype=x.dtype, device=x.device).index_add_(
        0, z, x[:, :, None] * x[:, None, :])
    linalg.counts.update(cholesky=0, solve=0)
    model.family.update(model.components_prior, GaussStats(sx, n1, xxT, n1))
    return linalg.counts['cholesky']


def branch_checks(dev, gen, errs):
    """B3 on HierTied rows and B5/B6 on every new basis x expert
    combination against their plain versions."""
    post = hier_from(random_posterior(gen, K_MAIN, D_MAIN, dev))
    log_w = torch.log_softmax(torch.randn((K_MAIN,), generator=gen,
                                          device=dev), 0)
    xt = (torch.randn((D_MAIN, N_CHECK), generator=gen, device=dev) * 4.0
          + post.mus[0][:, None])
    errs['B3-hier'] = 0.0
    for dist in ('studentt', 'gaussian'):
        thq, aux = cuda_predict.predictive_coefficients(
            post, log_w, dist == 'studentt')
        out = cuda_predict.predict(xt, thq, aux, N_CHECK, dist == 'studentt')
        ref = cuda_predict.predict_plain(xt, thq, aux, N_CHECK,
                                         dist == 'studentt')
        torch.cuda.synchronize()
        ok, e = allclose_report(out, ref, 1e-5, 1e-4)
        errs['B3-hier'] = max(errs['B3-hier'], e)
        print(f'B3-hier {dist} N={N_CHECK} K={K_MAIN} d={D_MAIN}: max|err| '
              f'{e:.6g} nats (rtol 1e-5, atol 1e-4) {"ok" if ok else "FAIL"};'
              f' finite {bool(torch.isfinite(out).all())}')
        check(ok and bool(torch.isfinite(out).all()),
              f'B3-hier {dist} disagrees')

    for name, d, p in (('B5-hilr', 1, 1), ('B6-hilr', D_P3, P_P3)):
        errs[name] = 0.0
        x, y = regression_data(gen, N_CHECK, d, p, dev)
        for basis_kind, experts_kind in (('NIW', 'tied-affine'),
                                         ('HierTied', 'MNW'),
                                         ('HierTied', 'MNG'),
                                         ('HierTied', 'tied-affine')):
            basis, experts = (random_mng_posterior(gen, K_MAIN, d, p, dev)
                              if experts_kind == 'MNG' else
                              random_ilr_posterior(gen, K_MAIN, d, p, dev))
            if basis_kind == 'HierTied':
                basis = hier_from(basis)
            if experts_kind == 'tied-affine':
                experts = tied_from(experts)
            log_w = torch.log_softmax(torch.randn((K_MAIN,), generator=gen,
                                                  device=dev), 0)
            for has_y in (True, False):
                xt = stack_rows(kernel_xts((x, y) if has_y else (x,)))
                for hard in (False, True):
                    if p == 1:
                        th, aux = cuda_ilr_predict.ilr_predict_coefficients(
                            basis, experts, log_w)
                        out = cuda_ilr_predict.ilr_predict(
                            xt, th, aux, N_CHECK, has_y, hard)
                        ref = cuda_ilr_predict.ilr_predict_plain(
                            xt, th, aux, N_CHECK, has_y, hard)
                    else:
                        th, aux, vc = \
                            cuda_ilr_predict.ilr_p_predict_coefficients(
                                basis, experts, log_w, True, has_y)
                        out = cuda_ilr_predict.ilr_p_predict(
                            xt, th, aux, vc, N_CHECK, p, has_y, hard)
                        ref = cuda_ilr_predict.ilr_p_predict_plain(
                            xt, th, aux, vc, N_CHECK, p, has_y, hard)
                    torch.cuda.synchronize()
                    ok, worst, flips = compare_serving(out, ref, p, hard)
                    print(f'{name[:2]} {basis_kind} x {experts_kind} '
                          f'N={N_CHECK} K={K_MAIN} d={d} p={p} '
                          f'{"mode" if hard else "average"} '
                          f'{"with" if has_y else "without"} y: max|err| '
                          f'{worst:.6g} (mean rtol/atol 1e-4, var '
                          f'2e-3/1e-5, nlpd 1e-3/2e-3, lse_w 1e-5/1e-4); '
                          f'points off {flips} {"ok" if ok else "FAIL"}')
                    check(ok, f'{name[:2]} {basis_kind} x {experts_kind} '
                          'disagrees')
                    errs[name] = max(errs[name], worst)


def probe_checks(dev, gen, card, n_main, errs, launches, ms):
    """S1 and S2 at N=n_main (a multiple of the 128-point tile), K=50,
    d=2: one launch of each variant as the probes' own run (the launch
    counts), each against its plain version, S2 also at the TPU probe's
    shape, then each timed beside B1 as it stands."""
    post = random_posterior(gen, K_MAIN, D_MAIN, dev)
    log_pi = torch.log_softmax(torch.randn((K_MAIN,), generator=gen,
                                           device=dev), 0)
    xt = (torch.randn((D_MAIN, n_main), generator=gen, device=dev) * 4.0
          + post.mu[0][:, None])
    theta, _ = pad_theta(gaussian_spec().theta(post), log_pi, torch.float32)
    nv_used = n_main - 99_997
    nv = torch.tensor([nv_used], dtype=torch.int32, device=dev)
    variants = {
        'S1-divide': (lambda: cuda_probes.regf(xt, theta, n_main, True),
                      True, None),
        'S1-nodivide': (lambda: cuda_probes.regf(xt, theta, n_main, False),
                        False, None),
        'S2-none': (lambda: cuda_probes.estep_count(xt, theta, n_main,
                                                    'none'), True, None),
        'S2-unused': (lambda: cuda_probes.estep_count(xt, theta, n_main,
                                                      'unused', nv),
                      True, None),
        'S2-used': (lambda: cuda_probes.estep_count(xt, theta, n_main,
                                                    'used', nv),
                    True, nv_used),
    }
    torch.cuda.synchronize()
    reset_counts()
    outs = {name: fn() for name, (fn, _, _) in variants.items()}
    torch.cuda.synchronize()
    for name in variants:
        launches[name] = cuda_probes.launches[name]
    print(f'probes N={n_main} K={K_MAIN} d={D_MAIN}: launches '
          f'{dict(cuda_probes.launches)}')
    check(all(launches[name] == 1 for name in variants),
          'a probe variant did not launch its kernel')
    for name, (_, divide, used) in variants.items():
        acc, lse = outs[name]
        pacc, plse = cuda_probes.estep_probe_plain(xt, theta, n_main, divide,
                                                   used)
        mag = estep_magnitudes(xt, theta, n_main, divide=divide, nv=used)
        err = (acc.double() - pacc.double()).abs()
        ok_s = bool((err <= 1e-5 * mag + 1e-6).all())
        ok_l, err_l = allclose_report(lse, plse, 1e-5, 0.0)
        errs[name] = float(err.max())
        print(f'{name} N={n_main}{f" nv={used}" if used else ""}: stats '
              f'max|err| {errs[name]:.6g}, max |err| / summed magnitude '
              f'{float((err / mag.clamp(min=1e-30)).max()):.3g} (<= 1e-5) '
              f'{"ok" if ok_s else "FAIL"}; lse |err| {err_l:.6g} (rtol '
              f'1e-5) {"ok" if ok_l else "FAIL"}')
        check(ok_s and ok_l and bool(torch.isfinite(acc).all()),
              f'{name} disagrees')
    # S1 with the divide is B1's own instantiation: bitwise B1
    acc_b1, lse_b1 = cuda_estep.estep(xt, theta, n_main)
    check(torch.equal(outs['S1-divide'][0], acc_b1)
          and torch.equal(outs['S1-divide'][1], lse_b1),
          'S1 with the divide is not B1')

    # S2 at the TPU probe's shape: K=8, d=2, N=4096, nv=4000
    th8 = torch.randn((8, 8), generator=gen, device=dev)
    th8[:, 1 + D_MAIN:7] = -0.2 * torch.eye(D_MAIN, device=dev).reshape(1, -1)
    th8[:, 7:] = 0.0
    x8 = torch.randn((D_MAIN, 4096), generator=gen, device=dev)
    nv8 = torch.tensor([4000], dtype=torch.int32, device=dev)
    for mode in ('none', 'unused', 'used'):
        used = 4000 if mode == 'used' else None
        acc, lse = cuda_probes.estep_count(x8, th8, 4096, mode, nv8)
        pacc, plse = cuda_probes.estep_probe_plain(x8, th8, 4096, True, used)
        mag = estep_magnitudes(x8, th8, 4096, nv=used)
        err = (acc.double() - pacc.double()).abs()
        ok = (bool((err <= 1e-5 * mag + 1e-6).all())
              and allclose_report(lse, plse, 1e-5, 0.0)[0])
        print(f'S2-{mode} K=8 d=2 N=4096{" nv=4000" if used else ""}: '
              f'counts {float(acc[:, 0].sum()):.6g} (plain '
              f'{float(pacc[:, 0].sum()):.6g}), stats max|err| '
              f'{float(err.max()):.6g} {"ok" if ok else "FAIL"}')
        check(ok, f'S2-{mode} disagrees at the probe shape')

    ms['B1-probe'] = (cuda_ms(lambda: cuda_estep.estep(xt, theta, n_main),
                              20), 0.0)
    m = cuda_estep.feature_width(cuda_estep.GAUSS, D_MAIN)
    for name, (fn, divide, used) in variants.items():
        WORK[name] = estep_work(used or n_main, K_MAIN, m, D_MAIN)
        ms[name] = (cuda_ms(fn, 20),
                    cuda_ms(lambda: cuda_probes.estep_probe_plain(
                        xt, theta, n_main, divide, used), 3))
        print(f'{name} time on {card} at N={n_main} K={K_MAIN} d={D_MAIN}: '
              f'kernel {ms[name][0]:.6g} ms, plain PyTorch {ms[name][1]:.6g} '
              f'ms; B1 in the same call {ms["B1-probe"][0]:.6g} ms')
    del xt, outs
    torch.cuda.empty_cache()


def gibbs_acc_err(xt, n, kind, p, labels, acc):
    """max |acc - one-hot sums of the labels' features|, in float64."""
    k, m8 = acc.shape
    ref = torch.zeros((k, m8), dtype=torch.float64, device=xt.device)
    for s in range(0, n, 1 << 20):
        e = min(s + (1 << 20), n)
        f = assemble_features(xt[:, s:e], m8, kind, p).double()
        oh = torch.nn.functional.one_hot(labels[s:e].long(), k).double()
        ref += oh.T @ f.T
    return float((acc.double() - ref).abs().max())


def gibbs_labels_check(tag, xt, theta, seed, n, kind=cuda_estep.GAUSS,
                       p=0):
    """B2 against its plain version at one theta and seed, under phase
    4's rule: labels in range and equal to the plain Philox labels (at
    most 1e-4 differ), statistics within 1e-5 of the summed magnitudes of
    the one-hot sums of its own labels. Returns (labels, acc)."""
    labels, acc = cuda_gibbs.gibbs(xt, theta, seed, n, kind, p)
    plabels, _ = cuda_gibbs.gibbs_plain(xt, theta, seed, n, kind, p)
    k, m8 = acc.shape
    ref = torch.zeros((k, m8), dtype=torch.float64, device=xt.device)
    mag = torch.zeros_like(ref)
    for s in range(0, n, 1 << 20):
        e = min(s + (1 << 20), n)
        f = assemble_features(xt[:, s:e], m8, kind, p).double()
        oh = torch.nn.functional.one_hot(labels[s:e].long(), k).double()
        ref += oh.T @ f.T
        mag += oh.T @ f.abs().T
    err = (acc.double() - ref).abs()
    ok_acc = bool((err <= 1e-5 * mag).all())
    in_range = int(labels.min()) >= 0 and int(labels.max()) < k
    mismatch = float((labels != plabels).double().mean())
    print(f'{tag} N={n} K={k}: labels in [0, {k}) {in_range}; stats vs '
          f'one-hot sums of its labels max|err| / summed magnitude '
          f'{float((err / mag.clamp(min=1e-30)).max()):.3g} (<= 1e-5) '
          f'{"ok" if ok_acc else "FAIL"}; label mismatch vs plain Philox '
          f'{mismatch:.3g} (<= 1e-4)')
    check(in_range and ok_acc and mismatch <= 1e-4, f'{tag}: B2 disagrees')
    return labels, acc


def time_pairs(card, tag, pairs, errs, ms):
    """Each (kernel, plain, err) triple timed by CUDA events (20 launches
    after 2 warm-ups; the plain 3). errs[name] takes the larger of its
    earlier value and this run's error: err() where given, else max
    |kernel - plain| of one run."""
    for name, (kern, plain, err) in pairs.items():
        if err is None:
            got, want = kern(), plain()
            got = got[0] if isinstance(got, tuple) else got
            want = want[0] if isinstance(want, tuple) else want
            e = float((got.double() - want.double()).abs().max())
        else:
            e = err()
        errs[name] = max(errs.get(name, 0.0), e)
        ms[name] = (cuda_ms(kern, 20), cuda_ms(plain, 3))
        print(f'{name} time on {card} at {tag}: kernel {ms[name][0]:.6g} ms, '
              f'plain PyTorch {ms[name][1]:.6g} ms; max|err| vs plain '
              f'{errs[name]:.6g}')


def time_library(card, tag, post, log_w, x, pairs):
    """LIBRARY[name]: the time of the one PyTorch call that computes the
    function of each of `pairs` (B4 / B4-tied: the Student-t mixture,
    B3-diag: the Gaussian one) on the same posterior and points, CUDA
    events over 3 runs after 2 warm-ups, beside its max |difference| from
    the plain version (which its time is not compared with)."""
    for name, pair in pairs.items():
        fn = library_mixture(post, log_w, x,
                             'gaussian' if name == 'B3-diag' else 'studentt')
        e = float((fn().double() - pair[1]().double()).abs().max())
        LIBRARY[name] = cuda_ms(fn, 3)
        print(f'{name} library call on {card} at {tag}: MixtureSameFamily('
              f'Categorical, Independent({"Normal" if name == "B3-diag" else "StudentT"}'
              f')).log_prob in 1e6-point chunks {LIBRARY[name]:.6g} ms; '
              f'max|diff| vs plain {e:.3g} nats')


def tied_gmm_paths(dev, seed, card, n_main, errs, launches, ms):
    """The tied GMM and tied diagonal GMM (the reference's tgmm / tdgmm,
    mimo_tpu/models/gmm.py:5-7, tests/test_gmm.py:145) and the
    hierarchical GMM (tests/test_pallas.py:100-118) at the shape of
    bench.py:90-98."""
    kg = torch.Generator(device=dev).manual_seed(seed)
    mu = torch.randn((3, D_MAIN), generator=kg, device=dev) * 4.0
    lm = torch.eye(D_MAIN, device=dev).expand(3, D_MAIN, D_MAIN) * 2.0
    x, _ = BayesianGMM.generate(kg, GaussParams(mu, lm), [.3, .4, .3],
                                n_main)
    xt = kernel_xts((x,))[0]
    configs = (
        ('tied', dict(gating='dp', tied=True, kappa=0.05, psi_scale=0.5),
         ('B1', 'B2', 'B3'), ('B1-tied', 'B2-tied', None)),
        ('diag-tied', dict(gating='dirichlet', diag=True, tied=True,
                           kappa=0.05),
         ('B1-diag', 'B2-diag', 'B4'),
         ('B1-diag-tied', 'B2-diag-tied', 'B4-tied')),
        ('hier', dict(gating='dp', hierarchical=True, kappa=0.05,
                      psi_scale=0.5, maxsubiter=25),
         ('B1', 'B2', 'B3'), ('B1-hier', 'B2-hier', 'B3-hier')))
    for label, kw, counts, names in configs:
        model = BayesianGMM.make(size=K_MAIN, dim=D_MAIN, device=dev, **kw)
        tag = f'{label} GMM N={n_main} K={K_MAIN} d={D_MAIN}'
        torch.cuda.synchronize()
        reset_counts()
        st, vlb = model.fit_vi_fused(x, key=1, maxiter=20)
        rounds = dict(hierarchical.counts)
        gs = model.fit_gibbs_fused(x, key=2, maxiter=20)
        lp = model.log_predictive(st, x)
        torch.cuda.synchronize()
        path = read_counts()
        print(f'{tag}: launches {path}')
        if label == 'hier':
            # the random start's update and one a sweep, 25 rounds each;
            # an update factors twice, whatever its rounds
            chols = hier_update_choleskys(model, x, gs.labels)
            print(f'{tag}: VI 20 inner rounds {rounds}; Choleskys an '
                  f'update {chols}')
            check(rounds == {'rounds': 25 * 21, 'updates': 21},
                  'the hier GMM VI fit ran other than 25 rounds an update')
            check(chols == 2,
                  'the hier update factored other than twice an update')
        check(path[counts[0]] == 20 and path[counts[1]] == 20
              and path[counts[2]] == 1,
              f'the {label} GMM path bypassed a kernel')
        for count, name in zip(counts, names):
            if name is not None:
                launches[name] = path[count]
        elbo_report(f'{tag} VI', vlb)
        check(all_finite(st) and all_finite(gs[:4])
              and gs.labels.shape == (n_main,) and int(gs.labels.min()) >= 0
              and int(gs.labels.max()) < K_MAIN,
              f'{label} GMM state not finite or labels out of range')
        check(lp.shape == (n_main,) and all_finite(lp),
              f'{label} GMM log_predictive not finite')
        counts_g = torch.bincount(gs.labels.long(), minlength=K_MAIN)
        big = torch.nonzero(counts_g >= 0.2 * n_main)[:, 0]
        g_mu = gs.components.mus if label == 'hier' else gs.components.mu
        near = torch.cdist(mu, g_mu[big]).min(1).values if len(big) else \
            torch.full((3,), math.inf, device=dev)
        shared = gs.params[1]
        top3 = torch.sort(st.gating.mean())[0][-3:]
        print(f'{tag}: VI top-3 weights '
              f'{[round(float(w), 4) for w in top3]}; Gibbs components '
              f'with >= 20% of points {len(big)}, true means within '
              f'{float(near.max()):.4g} of them; the Gibbs scale shared '
              f'over K '
              f'{bool(torch.equal(shared, shared[:1].expand(shared.shape)))};'
              f' mean log predictive {float(lp.mean()):.6g}')

        xs_ = x[:100_003]
        _, v_k = model.fit_vi_fused(xs_, maxiter=5, init_state=st,
                                    randomize=False, backend='kernel')
        _, v_t = model.fit_vi_fused(xs_, maxiter=5, init_state=st,
                                    randomize=False, backend='torch')
        ok_v, e_v = allclose_report(v_k, v_t, 1e-4, 0.0)
        ok_p, e_p = allclose_report(
            model.log_predictive(st, xs_, backend='kernel'),
            model.log_predictive(st, xs_, backend='torch'), 1e-4, 1e-4)
        print(f'{tag} vs plain on 100,003 points: VI ELBO max|err| '
              f'{e_v:.6g} (rtol 1e-4) {"ok" if ok_v else "FAIL"}; '
              f'log_predictive max|err| {e_p:.6g} (rtol/atol 1e-4) '
              f'{"ok" if ok_p else "FAIL"}')
        check(ok_v and ok_p,
              f'the {label} GMM kernel path disagrees with the plain path')

        vi = rate(20, lambda: model.fit_vi_fused(x, maxiter=20, init_state=st,
                                                 randomize=False))
        gibbs = rate(20, lambda: model.fit_gibbs_fused(x, key=3, maxiter=20))
        pred = rate(n_main, lambda: model.log_predictive(st, x))
        print(f'rates on {card}, {tag}: VI {vi} it/s (20 warm-started '
              f'sweeps); Gibbs {gibbs} sweeps/s (20 sweeps); predictive '
              f'{pred} pts/s')

        spec = model._estep_spec()
        kind = DIAG if label == 'diag-tied' else cuda_estep.GAUSS
        th_vi, _ = pad_theta(spec.theta(st.components),
                             st.gating.expected_log_pi(), torch.float32)
        th_g, _ = pad_theta(spec.theta_plugin(gs.params), gs.log_pi,
                            torch.float32)
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        log_w = model.predictive_log_weights(st)
        labels, acc = cuda_gibbs.gibbs(xt, th_g, zero, n_main, kind)
        pairs = {
            names[0]: (lambda: cuda_estep.estep(xt, th_vi, n_main, kind),
                       lambda: cuda_estep.estep_plain(xt, th_vi, n_main,
                                                      kind), None),
            names[1]: (lambda: cuda_gibbs.gibbs(xt, th_g, zero, n_main, kind),
                       lambda: cuda_gibbs.gibbs_plain(xt, th_g, zero, n_main,
                                                      kind),
                       lambda: gibbs_acc_err(xt, n_main, kind, 0, labels,
                                             acc)),
        }
        if label == 'diag-tied':
            rows4, aux4 = cuda_diag_predict.diag_predict_coefficients(
                st.components, log_w)
            pairs[names[2]] = (
                lambda: cuda_diag_predict.diag_predict(xt, rows4, aux4,
                                                       n_main),
                lambda: cuda_diag_predict.diag_predict_plain(xt, rows4, aux4,
                                                             n_main), None)
        elif label == 'hier':
            thq, aux = cuda_predict.predictive_coefficients(st.components,
                                                            log_w)
            pairs[names[2]] = (
                lambda: cuda_predict.predict(xt, thq, aux, n_main),
                lambda: cuda_predict.predict_plain(xt, thq, aux, n_main),
                None)
        m = cuda_estep.feature_width(kind, D_MAIN)
        WORK[names[0]] = estep_work(n_main, K_MAIN, m, D_MAIN)
        WORK[names[1]] = gibbs_work(xt, th_g, n_main, m, kind)
        if names[2] is not None:
            WORK[names[2]] = (
                b4_work(n_main, D_MAIN, aux4) if label == 'diag-tied' else
                density_work(n_main, K_MAIN, quad_fmas(D_MAIN), D_MAIN, 2,
                             products=point_products(D_MAIN)))
        time_pairs(card, f'N={n_main} K={K_MAIN} d={D_MAIN} ({label} GMM)',
                   pairs, errs, ms)
        if label == 'diag-tied':
            time_library(card, tag, st.components, log_w, x,
                         {'B4-tied': pairs['B4-tied']})
        del model, st, gs, lp
        torch.cuda.empty_cache()
    del x, xt
    torch.cuda.empty_cache()


def hilr_serving_paths(dev, seed, card, errs, launches, ms):
    """The tied-activation ILR (tests/test_ilr.py:166-187, the reference's
    hilr with tied activation): the sine flagship at N=1e7 through B5 and
    p>1 serving (tests/test_pallas.py:436-471's shape at K=50) through
    B6."""
    for count, n, d, p in (('B5', N_SINE, 1, 1), ('B6', N_P3, D_P3, P_P3)):
        name = f'{count}-hilr'
        kg = torch.Generator(device=dev).manual_seed(seed + 7)
        if p == 1:
            x = torch.rand((n, 1), generator=kg, device=dev) * 12 - 6
            y = torch.sin(x) + 0.1 * torch.randn((n, 1), generator=kg,
                                                 device=dev)
            kw = dict(alpha=5.0, kappa=0.05, maxsubiter=10)
        else:
            x, y = regression_data(kg, n, d, p, dev, fn=torch.tanh)
            kw = dict(alpha=2.0, kappa=0.1)
        model = BayesianILR.make(size=K_MAIN, input_dim=d, output_dim=p,
                                 tied_affine=True, hier_basis=True,
                                 device=dev, **kw)
        model.init_transform(x, y)
        torch.cuda.synchronize()
        reset_counts()
        if p == 1:
            # tests/test_ilr.py:181's Gibbs 60, over the first N_HILR_GIBBS
            # points, then VI over all n warm-started from it. From the
            # symmetric start a chain over all 1e7 points stays in a
            # one-slope, y-banded mode (RMSE ~0.67) for over 1,000 sweeps;
            # mimo_tpu's own chain does so from N ~ 1e5 (PERF.md §6).
            sub = (x[:N_HILR_GIBBS], y[:N_HILR_GIBBS])
            g = model.fit_gibbs_fused(sub, key=0, maxiter=60)
            st, vlb = model.fit_vi_fused(
                (x, y), key=1, maxiter=20,
                init_state=MFState(g.components, g.gating), randomize=False)
        else:
            st, vlb = model.fit_vi_fused((x, y), key=1, maxiter=20)
        mu, var, _, nlpd = model.predict(st, x, y)
        torch.cuda.synchronize()
        path = read_counts()
        launches[name] = path[count]
        if p == 1:
            launches['B1-ILR-hilr'] = path['B1-ILR']
            launches['B2-ILR-hilr'] = path['B2-ILR']
        tag = (f'hilr serving ({"sine" if p == 1 else "tanh"}) N={n} '
               f'K={K_MAIN} d={d} p={p}')
        print(f'{tag}: launches {path}')
        check(path[count] == 1 and path['B1-ILR'] == 20
              and path['B2-ILR'] == (60 if p == 1 else 0),
              'the hilr serving path bypassed a kernel')
        check(isinstance(st.components[0], HierTied)
              and isinstance(st.components[1], TiedAffine),
              'the hilr path fitted the wrong families')
        elbo_report(f'{tag} VI', vlb)
        rmse = float(torch.sqrt(torch.mean((mu - y) ** 2)))
        print(f'{tag}: RMSE {rmse:.6g} (noise floor 0.1'
              f'{", bound 0.35" if p == 1 else ""}), mean NLPD '
              f'{float(nlpd.mean()):.6g} nats, original units')
        check(mu.shape == (n, p) and var.shape == (n, p)
              and nlpd.shape == (n,) and all_finite((mu, var, nlpd)),
              'hilr predict not finite or of the wrong shape')
        if p == 1:
            check(rmse < 0.35, f'hilr sine RMSE {rmse:.4g} >= 0.35')
        engines_vs_plain(model, st, x, y)

        pred = rate(n, lambda: model.predict(st, x, y))
        print(f'rates on {card}, {tag}: predict {pred} pts/s (weights, '
              f'moments and NLPD, original units)')
        if p == 1:
            vi = rate(20, lambda: model.fit_vi_fused(
                (x, y), maxiter=20, init_state=st, randomize=False))
            gibbs = rate(20, lambda: model.fit_gibbs_fused((x, y), key=3,
                                                           maxiter=20))
            print(f'rates on {card}, {tag}: VI {vi} it/s (20 warm-started '
                  f'sweeps, 10 inner rounds each); Gibbs {gibbs} sweeps/s')
        basis, experts = st.components
        log_w = model.predictive_log_weights(st)
        xt = stack_rows(kernel_xts((model._tx(x), model._ty(y))))
        if p == 1:
            th, aux = cuda_ilr_predict.ilr_predict_coefficients(
                basis, experts, log_w)
            pairs = {name: (
                lambda: cuda_ilr_predict.ilr_predict(xt, th, aux, n, True,
                                                     False),
                lambda: cuda_ilr_predict.ilr_predict_plain(xt, th, aux, n,
                                                           True, False),
                None)}
            spec = model._estep_spec()
            th_vi, _ = pad_theta(spec.theta(st.components),
                                 st.gating.expected_log_pi(), torch.float32)
            th_g, _ = pad_theta(spec.theta_plugin(g.params), g.log_pi,
                                torch.float32)
            zero = torch.zeros((), dtype=torch.int64, device=dev)
            labels, acc = cuda_gibbs.gibbs(xt, th_g, zero, n, ILR, 1)
            pairs['B1-ILR-hilr'] = (
                lambda: cuda_estep.estep(xt, th_vi, n, ILR, 1),
                lambda: cuda_estep.estep_plain(xt, th_vi, n, ILR, 1), None)
            pairs['B2-ILR-hilr'] = (
                lambda: cuda_gibbs.gibbs(xt, th_g, zero, n, ILR, 1),
                lambda: cuda_gibbs.gibbs_plain(xt, th_g, zero, n, ILR, 1),
                lambda: gibbs_acc_err(xt, n, ILR, 1, labels, acc))
        else:
            th, aux, vc = cuda_ilr_predict.ilr_p_predict_coefficients(
                basis, experts, log_w)
            pairs = {name: (
                lambda: cuda_ilr_predict.ilr_p_predict(xt, th, aux, vc, n, p,
                                                       True, False),
                lambda: cuda_ilr_predict.ilr_p_predict_plain(
                    xt, th, aux, vc, n, p, True, False),
                None)}
        if p == 1:
            m = cuda_estep.feature_width(ILR, d, p)
            WORK[name] = serving_work(n, K_MAIN, d, p)
            WORK['B1-ILR-hilr'] = estep_work(n, K_MAIN, m, d + p)
            WORK['B2-ILR-hilr'] = gibbs_work(xt, th_g, n, m, ILR, 1)
        else:
            WORK[name] = serving_work(n, K_MAIN, d, p)
        time_pairs(card, f'N={n} K={K_MAIN} d={d} p={p} (hilr)', pairs, errs,
                   ms)
        del x, y, model, st, mu, var, nlpd, xt
        torch.cuda.empty_cache()


WIDE_B3 = ((500, 2), (256, 8), (16, 24))   # (K, d) B3 refused before
WIDE_B5 = (194, 500)                        # K at d = 8
K_WIDE_B4, D_WIDE_B4, K_WIDE_B6 = 64, 32, 300


def wide_serving_paths(dev, gen, card, errs, launches, ms):
    """Phase 16: the serving kernels at shapes they refused before their
    coefficients were streamed in K-chunks, N=1,000,003 each. Each shape
    is served once through the public entry point (log_predictive,
    predict; backend='auto') with the launch counts set to 0 just before
    and read just after, then the kernel is held against its plain
    version on the same inputs and both are timed. B3 at K=500, d=2 (a
    DP-GMM after 3 VI sweeps), K=256, d=8 and K=16, d=24 (random NIW
    posteriors), Student-t and Gaussian; B4 at K=64, d=32 (random NG);
    B5 at K=194 and 500, d=8; B6 at K=300, d=2, p=3 with MNW and MNG
    experts (random posteriors), average and mode."""
    n = N_CHECK
    rows = {}
    for k, d in WIDE_B3:
        basis, _ = random_ilr_posterior(gen, k, d, 1, dev)
        idx = torch.randint(0, k, (n,), generator=gen, device=dev)
        x = basis.mu[idx] + torch.randn((n, d), generator=gen, device=dev)
        model = BayesianGMM.make(size=k, dim=d, gating='dp', kappa=0.05,
                                 psi_scale=0.5, device=dev)
        if k == 500:
            st, _ = model.fit_vi_fused(x, key=1, maxiter=3)
        else:
            st = MFState(basis, StickBreaking(
                gamma=1.0 + 1e4 * torch.rand((k,), generator=gen, device=dev),
                delta=1.0 + 1e4 * torch.rand((k,), generator=gen,
                                             device=dev)))
        torch.cuda.synchronize()
        reset_counts()
        lps = [model.log_predictive(st, x, dist=dist)
               for dist in ('studentt', 'gaussian')]
        torch.cuda.synchronize()
        name = f'B3-K{k}-d{d}'
        launches[name] = read_counts()['B3']
        check(launches[name] == 2 and all(
            bool(torch.isfinite(lp).all()) for lp in lps),
              f'{name}: log_predictive bypassed B3 or is not finite')
        xt = kernel_xts((x,))[0]
        log_w = model.predictive_log_weights(st)
        errs[name] = 0.0
        for dist in ('studentt', 'gaussian'):
            thq, aux = cuda_predict.predictive_coefficients(
                st.components, log_w, dist == 'studentt')
            ok, e = allclose_report(
                cuda_predict.predict(xt, thq, aux, n, dist == 'studentt'),
                cuda_predict.predict_plain(xt, thq, aux, n,
                                           dist == 'studentt'), 1e-5, 1e-4)
            print(f'{name} {dist} N={n}: max|err| {e:.6g} nats (rtol 1e-5, '
                  f'atol 1e-4) {"ok" if ok else "FAIL"}')
            check(ok, f'{name} {dist} disagrees')
            errs[name] = max(errs[name], e)
        thq, aux = cuda_predict.predictive_coefficients(st.components, log_w)
        rows[name] = (
            f'B3 Student-t mixture predictive, K={k} d={d} (wide)',
            'mimo_tpu_torch/csrc/predict.cu',
            'mimo_tpu/ops/pallas_predict.py:39',
            lambda: cuda_predict.predict(xt, thq, aux, n),
            lambda: cuda_predict.predict_plain(xt, thq, aux, n),
            density_work(n, k, quad_fmas(d), d, 2,
                         products=point_products(d)))
        time_wide(card, f'N={n} K={k} d={d}', name, rows[name], ms)
        if d > 8:       # the padded widths' float64 lines
            serving_precision_cells(name, cuda_predict.predict,
                                    cuda_predict.predict_plain, xt, thq,
                                    (aux, n), (('nats', 'log density'),), d,
                                    slice(None))
        del x, xt, model, st, lps

    k, d = K_WIDE_B4, D_WIDE_B4
    post = random_ng_posterior(gen, k, d, dev)
    idx = torch.randint(0, k, (n,), generator=gen, device=dev)
    x = post.mu[idx] + 0.5 * torch.randn((n, d), generator=gen, device=dev)
    model = BayesianGMM.make(size=k, dim=d, diag=True, device=dev)
    st = MFState(post, Dirichlet(alpha=1.0 + 1e4 * torch.rand(
        (k,), generator=gen, device=dev)))
    torch.cuda.synchronize()
    reset_counts()
    lp = model.log_predictive(st, x)
    torch.cuda.synchronize()
    name = f'B4-K{k}-d{d}'
    launches[name] = read_counts()['B4']
    check(launches[name] == 1 and bool(torch.isfinite(lp).all()),
          f'{name}: log_predictive bypassed B4 or is not finite')
    xt = kernel_xts((x,))[0]
    rows4, aux = cuda_diag_predict.diag_predict_coefficients(
        post, model.predictive_log_weights(st))
    ok, errs[name] = allclose_report(
        cuda_diag_predict.diag_predict(xt, rows4, aux, n),
        cuda_diag_predict.diag_predict_plain(xt, rows4, aux, n), 1e-4, 1e-4)
    print(f'{name} N={n}: max|err| {errs[name]:.6g} nats (rtol 1e-4, atol '
          f'1e-4) {"ok" if ok else "FAIL"}')
    check(ok, f'{name} disagrees')
    rows[name] = (
        f'B4 diagonal (NG) Student-t mixture predictive, K={k} d={d} (wide)',
        'mimo_tpu_torch/csrc/diag_predict.cu',
        'mimo_tpu/ops/pallas_predict.py:171',
        lambda: cuda_diag_predict.diag_predict(xt, rows4, aux, n),
        lambda: cuda_diag_predict.diag_predict_plain(xt, rows4, aux, n),
        b4_work(n, d, aux))
    time_wide(card, f'N={n} K={k} d={d}', name, rows[name], ms)
    log_w = model.predictive_log_weights(st)
    time_library(card, f'N={n} K={k} d={d}', post, log_w, x,
                 {name: rows[name][3:5]})
    mu_t, lam_t, _ = ng.predictive_studentt_params(post)
    serving_precision_cells(
        name, cuda_diag_predict.diag_predict,
        cuda_diag_predict.diag_predict_plain, xt, rows4, (aux, n),
        (('nats', 'log density'),), d, None,
        centres=(mu_t.double(), lam_t.double().min(-1).values ** -0.5),
        translate=translate_b4_rows)
    del x, xt, model, st, lp

    for k, d, p, diag in ([(k, D_Q8, 1, False) for k in WIDE_B5]
                          + [(K_WIDE_B6, D_P3, P_P3, False),
                             (K_WIDE_B6, D_P3, P_P3, True)]):
        count = 'B5' if p == 1 else 'B6'
        name = f'{count}{"-MNG" if diag else ""}-K{k}-d{d}'
        basis, experts = (random_mng_posterior if diag else
                          random_ilr_posterior)(gen, k, d, p, dev)
        x, y = regression_data(gen, n, d, p, dev)
        model = BayesianILR.make(size=k, input_dim=d, output_dim=p,
                                 diag=diag, device=dev)
        st = MFState((basis, experts), StickBreaking(
            gamma=1.0 + 1e4 * torch.rand((k,), generator=gen, device=dev),
            delta=1.0 + 1e4 * torch.rand((k,), generator=gen, device=dev)))
        torch.cuda.synchronize()
        reset_counts()
        got = model.predict(st, x, y)
        torch.cuda.synchronize()
        launches[name] = read_counts()[count]
        check(launches[name] == 1 and all_finite(got[:2]) and all_finite(
            got[3]), f'{name}: predict bypassed {count} or is not finite')
        xt = stack_rows(kernel_xts((x, y)))
        log_w = model.predictive_log_weights(st)
        if p == 1:
            th, aux = cuda_ilr_predict.ilr_predict_coefficients(
                basis, experts, log_w)
            kern, plain = (cuda_ilr_predict.ilr_predict,
                           cuda_ilr_predict.ilr_predict_plain)
            args = (xt, th, aux, n, True)
        else:
            th, aux, vc = cuda_ilr_predict.ilr_p_predict_coefficients(
                basis, experts, log_w)
            kern, plain = (cuda_ilr_predict.ilr_p_predict,
                           cuda_ilr_predict.ilr_p_predict_plain)
            args = (xt, th, aux, vc, n, p, True)
        errs[name] = 0.0
        for hard in (False, True):
            ok, worst, flips = compare_serving(kern(*args, hard),
                                               plain(*args, hard), p, hard)
            print(f'{name} N={n} p={p} {"mode" if hard else "average"} with '
                  f'y: max|err| {worst:.6g} (the serving tolerances); points '
                  f'off {flips} {"ok" if ok else "FAIL"}')
            check(ok, f'{name} disagrees')
            errs[name] = max(errs[name], worst)
        rows[name] = (
            f'{count} ILR predict, p={p}{", MNG experts" if diag else ""}, '
            f'K={k} d={d} (wide)', 'mimo_tpu_torch/csrc/ilr_predict.cuh',
            'mimo_tpu/ops/pallas_predict.py:' + ('656' if p == 1 else '349'),
            functools.partial(kern, *args, False),
            functools.partial(plain, *args, False),
            serving_work(n, k, d, p, diag))
        time_wide(card, f'N={n} K={k} d={d} p={p}', name, rows[name], ms)
        del x, y, xt, model, st, got
    torch.cuda.empty_cache()
    return rows


def time_wide(card, tag, name, row, ms):
    """Time one wide shape's kernel (5 launches) and plain version (2)."""
    _, _, _, kern, plain, work = row
    WORK[name] = work
    ms[name] = (cuda_ms(kern, 5), cuda_ms(plain, 2))
    print(f'{name} time on {card} at {tag}: kernel {ms[name][0]:.6g} ms, '
          f'plain PyTorch {ms[name][1]:.6g} ms')


# -- 17. engines ---------------------------------------------------------------

def plugin_fit(model, data, engine, maxiter, count, tag, key):
    """One fused MAP or ML-EM fit through its public entry point, with
    every count set to 0 just before: B1 (`count`) launched exactly once
    a sweep and no other kernel; a finite state and trace; the fit's peak
    device memory."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    state, trace = getattr(model, engine)(data, key=key, maxiter=maxiter)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    path = read_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f'{tag} {engine} {maxiter}: launches {path}')
    check(path[count] == maxiter and sum(path.values()) == maxiter,
          f'{tag} {engine}: B1 not launched once a sweep')
    launched = path[count]
    check(bool(torch.isfinite(trace).all()) and all_finite(state),
          f'{tag} {engine}: state or trace not finite')
    t = trace.double()
    drop = float(((t[:-1] - t[1:]) / t[1:].abs()).max())
    print(f'{tag} {engine}: loglik trace {float(t[0]):.9g} -> '
          f'{float(t[-1]):.9g}, worst relative drop {drop:.3g}'
          + (' (<= 1e-4)' if engine == 'fit_em_fused' else
             ' (MAP: the data log-likelihood at the mode; not checked)')
          + f'; peak device memory {peak / 2**30:.4g} GiB '
          f'({(peak - base) / 2**30:.4g} GiB above the {base / 2**30:.4g} '
          f'GiB held before the fit); one run {maxiter / secs:.6g} it/s '
          f'(init included)')
    if engine == 'fit_em_fused':
        check(drop <= 1e-4, f'{tag} EM loglik falls')
    return state, launched


def plugin_spec(model):
    """The plug-in E-step's spec: the flat model's, or the nested model's
    over its M*K flat rows."""
    if isinstance(model, BayesianMixtureOfMixtures):
        return model._flat_spec()
    return model._estep_spec()


def plugin_theta(model, engine, state):
    """B1's padded plug-in theta at a fit's final state: the mode's params
    and log weights (MAP) or the ML params and log_pi (EM); a nested
    model's (M, K)-stacked ones flattened m-major."""
    spec = plugin_spec(model)
    if isinstance(model, BayesianMixtureOfMixtures):
        if engine == 'fit_map_fused':
            params = vmap(model.family.mode_params)(state.components)
            log_pi = model._flat_log_pi(state, mode=True)
        else:
            params = state.params
            log_pi = (state.outer_log_pi[:, None]
                      + state.inner_log_pi).reshape(-1)
    elif engine == 'fit_map_fused':
        params = model.family.mode_params(state.components)
        log_pi = torch.log(torch.clamp(state.gating.mode(), min=1e-37))
    else:
        params, log_pi = state.params, state.log_pi
    return pad_theta(spec.theta_plugin(params), log_pi, torch.float32)[0]


def map_given_em(model, data, em_state):
    """A MAP state whose components differ: the posterior given the
    responsibilities at the ML-EM fit's final params (one MAP M-step from
    that fit), by the plain E-step. MAP from its random start stays near
    the symmetric point, where every row of theta is alike."""
    spec = plugin_spec(model)
    spec = spec._replace(theta=spec.theta_plugin)
    shards = _Shards(None, data, 'torch')
    if isinstance(model, BayesianMixtureOfMixtures):
        log_pi = (em_state.outer_log_pi[:, None]
                  + em_state.inner_log_pi).reshape(-1)
        res = shards.estep(spec, em_state.params, log_pi)
        counts, stats = model._split_flat(res)
        return model._update_from(stats, counts)
    res = shards.estep(spec, em_state.params, em_state.log_pi)
    return MFState(
        components=model.family.update(model.components_prior, res.stats),
        gating=model.gating_prior.update(res.counts))


def plugin_slice_check(tag, xt, theta, kind, p):
    """B1 against its plain version at one plug-in theta on the first
    100,003 points, under the ILR phase's rule: statistics within 1e-5 of
    their summed magnitudes (+ 1e-6), lse within rtol 1e-5."""
    n = 100_003
    xs = xt[:, :n].contiguous()
    acc, lse = cuda_estep.estep(xs, theta, n, kind, p)
    pacc, plse = cuda_estep.estep_plain(xs, theta, n, kind, p)
    mag = estep_magnitudes(xs, theta, n, kind, p)
    err = (acc.double() - pacc.double()).abs()
    ok_s = bool((err <= 1e-5 * mag + 1e-6).all())
    ok_l, err_l = allclose_report(lse, plse, 1e-5, 0.0)
    spread = float((theta - theta.mean(0)).abs().max())
    print(f'B1 {tag} vs plain on {n} points: theta rows differ by up to '
          f'{spread:.6g}; stats max |err| / summed magnitude '
          f'{float((err / mag.clamp(min=1e-30)).max()):.3g} (<= 1e-5) '
          f'{"ok" if ok_s else "FAIL"}; lse |err| {err_l:.6g} (rtol 1e-5) '
          f'{"ok" if ok_l else "FAIL"}')
    check(ok_s and ok_l, f'B1 {tag} disagrees with plain')


def plugin_paths(card, tag, model, data, sweeps, names, count, kind, p, n,
                 errs, launches, ms):
    """MAP-EM and ML-EM of one cell: the fits (launch counts, traces),
    kernel vs plain on the first 100,003 points (5 sweeps from the same
    init, traces within rtol 1e-4), rates, and B1 at each final theta
    checked against its plain version on those points, timed beside it
    and held to float64. MAP's final theta is near-symmetric, so B1 is
    also checked at the MAP theta given the ML-EM fit (`map_given_em`)."""
    xt = stack_rows(kernel_xts(data))
    d = data[0].shape[1]
    m = cuda_estep.feature_width(kind, d, p)
    pairs = {}
    for engine, key, name in (('fit_map_fused', 1, names[0]),
                              ('fit_em_fused', 0, names[1])):
        st, launches[name] = plugin_fit(model, data, engine, sweeps, count,
                                        tag, key)
        sl = tuple(a[:100_003] for a in data)
        _, t_k = getattr(model, engine)(sl, key=key, maxiter=5,
                                        backend='kernel')
        _, t_t = getattr(model, engine)(sl, key=key, maxiter=5,
                                        backend='torch')
        ok, e = allclose_report(t_k, t_t, 1e-4, 0.0)
        print(f'{tag} {engine} vs plain on 100,003 points: loglik max|err| '
              f'{e:.6g} (rtol 1e-4) {"ok" if ok else "FAIL"}')
        check(ok, f'{tag} {engine}: kernel path disagrees with plain')
        r = rate(sweeps, lambda: getattr(model, engine)(
            data, key=key, maxiter=sweeps), reps=3)
        print(f'rates on {card}, {tag}: {engine} {r} it/s ({sweeps} sweeps '
              f'a fit, its init included)')
        theta = plugin_theta(model, engine, st)
        print(f'{tag} {engine}: final plug-in theta max|entry| '
              f'{float(theta.abs().max()):.6g}')
        pairs[name] = (lambda th=theta: cuda_estep.estep(xt, th, n, kind, p),
                       lambda th=theta: cuda_estep.estep_plain(xt, th, n,
                                                               kind, p),
                       None)
        WORK[name] = estep_work(n, theta.shape[0], m, xt.shape[0])
        plugin_slice_check(f'{tag} {engine} final theta', xt, theta, kind, p)
        precision_check(f'{tag} {engine} final theta', xt, theta, n, kind,
                        p)
    # st is the ML-EM fit's final state (the loop's last engine)
    theta = plugin_theta(model, 'fit_map_fused', map_given_em(model, data, st))
    plugin_slice_check(f'{tag} MAP theta given the ML-EM fit', xt, theta,
                       kind, p)
    precision_check(f'{tag} MAP theta given the ML-EM fit', xt, theta, n,
                    kind, p)
    time_pairs(card, tag, pairs, errs, ms)


def engine_paths(dev, seed, card, n_main, errs, launches, ms):
    """Phase 17: MAP-EM and ML-EM through B1 (bench.py:153-166 and the q8
    cell of bench.py:313-336), the dense engines on a cut of phase 6's
    data, and SVI (bench.py:190-199)."""
    kg = torch.Generator(device=dev).manual_seed(seed)
    mu = torch.randn((3, D_MAIN), generator=kg, device=dev) * 4.0
    lm = torch.eye(D_MAIN, device=dev).expand(3, D_MAIN, D_MAIN) * 2.0
    x, _ = BayesianGMM.generate(kg, GaussParams(mu, lm), [.3, .4, .3],
                                n_main)
    model = BayesianGMM.make(size=K_MAIN, dim=D_MAIN, gating='dp', alpha=1.0,
                             kappa=0.05, psi_scale=0.5, device=dev)
    plugin_paths(card, f'engines N={n_main} K={K_MAIN} d={D_MAIN}', model,
                 (x,), 50, ('B1-MAP', 'B1-EM'), 'B1', cuda_estep.GAUSS, 0,
                 n_main, errs, launches, ms)

    kq = torch.Generator(device=dev).manual_seed(seed + 3)
    xq, yq = regression_data(kq, N_Q8, D_Q8, 1, dev)
    ilr = BayesianILR.make(size=K_MAIN, input_dim=D_Q8, output_dim=1,
                           alpha=2.0, kappa=0.05, device=dev)
    plugin_paths(card, f'engines ILR N={N_Q8} K={K_MAIN} d={D_Q8} p=1', ilr,
                 (xq, yq), 20, ('B1-ILR-MAP', 'B1-ILR-EM'), 'B1-ILR', ILR, 1,
                 N_Q8, errs, launches, ms)
    del xq, yq, ilr
    torch.cuda.empty_cache()

    # the dense engines on the first 1e6 points: plain PyTorch, as in JAX
    n_dense = min(1_000_000, n_main)
    x1 = x[:n_dense]
    tag = f'dense N={n_dense} K={K_MAIN} d={D_MAIN} (phase 6 data, cut)'
    dense = (
        ('fit_vi', lambda: model.fit_vi(x1, key=1, maxiter=20)),
        ('fit_map', lambda: model.fit_map(x1, key=1, maxiter=20)),
        ('fit_em', lambda: model.fit_em(x1, key=0, maxiter=20)),
        ('fit_gibbs', lambda: model.fit_gibbs(x1, key=2, maxiter=20,
                                              track_loglik=True)),
        ('GMM.fit_em', lambda: GMM(K_MAIN, D_MAIN).fit_em(x1, key=0,
                                                          maxiter=20)))
    torch.cuda.synchronize()
    reset_counts()
    for name, fit in dense:
        st, trace = fit()
        check(all_finite(st) and bool(torch.isfinite(trace).all())
              and trace.shape == (20,), f'{tag} {name} not finite')
        r = rate(20, fit, reps=2)
        print(f'{tag} {name} 20: trace {float(trace[0]):.9g} -> '
              f'{float(trace[-1]):.9g}; rate on {card} {r} it/s')
    torch.cuda.synchronize()
    path = read_counts()
    print(f'{tag}: launches {path} (none: the dense engines are plain)')
    check(sum(path.values()) == 0, 'a dense engine launched a kernel')

    # SVI over all the points, from the random init and warm
    for b, steps in ((256, 500), (65536, 200)):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, _ = model.fit_svi(x, key=5, maxiter=steps, step_size=0.5,
                              batch_size=b)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        check(all_finite(st), f'SVI B={b} state not finite')
        t0 = time.perf_counter()
        st2, _ = model.fit_svi(x, key=6, maxiter=steps, step_size=0.5,
                               batch_size=b, init_state=st)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        check(all_finite(st2), f'SVI B={b} warm state not finite')
        check(sum(read_counts().values()) == 0, 'SVI launched a kernel')
        top = torch.sort(st2.gating.mean())[0][-3:]
        print(f'SVI N={n_main} K={K_MAIN} d={D_MAIN} B={b} {steps} steps on '
              f'{card}: {steps / cold:.6g} steps/s from the random init '
              f'(init included), {steps / warm:.6g} steps/s warm '
              f'({steps / warm * b:.6g} pts/s through the E-step); top-3 '
              f'weights {[round(float(w), 4) for w in top]}')
    del x, x1, model
    torch.cuda.empty_cache()


# -- 18. nested ---------------------------------------------------------------

N_NEST, M_NEST, K_NEST = 1_000_000, 4, 8      # bench.py:358-383
N_NEST_MAP = 10_000_000                        # bench.py:385-398
N_NEST_ILR, N_NEST_ILR_FIT = 10_000_000, 200_000   # bench.py:400-420
N_NEST_P2, N_NEST_P2_FIT = 1_000_000, 100_000  # tests/test_pallas.py:474-499
N_NEST_DENSE = 100_000


def nested_blobs(gen, n, dev):
    """bench.py:358-383's nested data: n/2 points at (-5, -4) and n/2 at
    (5, 4), sigma 0.7, shuffled (so that every slice holds both)."""
    c = torch.tensor([[-5., -4.], [5., 4.]], device=dev)
    lab = torch.arange(n, device=dev) % 2
    x = c[lab] + 0.7 * torch.randn((n, 2), generator=gen, device=dev)
    return x[torch.randperm(n, generator=gen, device=dev)]


def nested_fit(tag, fit, want):
    """One fit through its public entry point with every count set to 0
    just before and read just after: exactly the `want` launches (a dict
    of read_counts() names) and no other kernel. Returns (result, counts,
    seconds)."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = fit()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    path = read_counts()
    print(f'{tag}: launches {path}')
    check(all(path[k] == v for k, v in want.items())
          and sum(path.values()) == sum(want.values()),
          f'{tag}: launches {path}, want {want}')
    return out, path, secs


def nested_gmm_paths(dev, seed, card, errs, launches, ms):
    """Cells 1 and 2 of phase 18: the nested GMM and the hierarchical
    nested GMM of bench.py:358-383 (N=1e6, M=4, K=8, d=2) through B1/B2/B3
    at M*K = 32 rows."""
    kg = torch.Generator(device=dev).manual_seed(seed + 11)
    x = nested_blobs(kg, N_NEST, dev)
    xt = kernel_xts((x,))[0]
    xs = x[:100_003]
    n, mk = N_NEST, M_NEST * K_NEST
    m = cuda_estep.feature_width(cuda_estep.GAUSS, 2)
    for label, hier, sweeps in (('', False, 50), ('-hier', True, 20)):
        tag = (f'nested{" hierarchical" if hier else ""} GMM N={n} '
               f'M={M_NEST} K={K_NEST} d=2')
        model = BayesianMixtureOfMixtures.make_gmm(
            M_NEST, K_NEST, 2, hierarchical=hier, kappa=0.5, psi_scale=0.5,
            maxsubiter=5, device=dev)
        (st, vlb), path, t_vi = nested_fit(
            f'{tag} fit_vi_fused {sweeps}',
            lambda: model.fit_vi_fused(x, key=0, maxiter=sweeps),
            {'B1': sweeps})
        launches[f'B1-nested{label}'] = path['B1']
        gs, path, t_g = nested_fit(
            f'{tag} fit_gibbs_fused {sweeps}',
            lambda: model.fit_gibbs_fused(x, key=2, maxiter=sweeps),
            {'B2': sweeps})
        launches[f'B2-nested{label}'] = path['B2']
        lp, path, t_p = nested_fit(f'{tag} log_predictive',
                                   lambda: model.log_predictive(st, x),
                                   {'B3': 1})
        launches[f'B3-nested{label}'] = path['B3']
        elbo_report(f'{tag} VI', vlb)
        check(all_finite(st) and all_finite(gs[:3])
              and gs.labels.shape == (n,) and int(gs.labels.min()) >= 0
              and int(gs.labels.max()) < M_NEST,
              f'{tag}: state not finite or labels out of range')
        check(lp.shape == (n,) and all_finite(lp),
              f'{tag}: log_predictive not finite')
        if hier:
            check(model.family.gibbs_update is not None,
                  f'{tag}: Gibbs without the exact draws')
        counts = torch.bincount(gs.labels.long(), minlength=M_NEST)
        print(f'{tag}: outer weights (VI) '
              f'{[round(float(w), 4) for w in st.outer_gating.mean()]}; '
              f'Gibbs outer label counts {counts.tolist()}; mean log '
              f'predictive {float(lp.mean()):.6g}; one run each on {card}: '
              f'VI {sweeps / t_vi:.6g} it/s, Gibbs {sweeps / t_g:.6g} '
              f'sweeps/s, predictive {n / t_p:.6g} pts/s (first calls)')

        # the engines' kernel path against their plain path on a slice
        _, v_k = model.fit_vi_fused(xs, key=0, maxiter=5, backend='kernel')
        _, v_t = model.fit_vi_fused(xs, key=0, maxiter=5, backend='torch')
        ok_v, e_v = allclose_report(v_k, v_t, 1e-4, 0.0)
        lp_k = model.log_predictive(st, xs, backend='kernel')
        ok_p, e_p = allclose_report(
            lp_k, model.log_predictive(st, xs, backend='torch'), 1e-5, 1e-4)
        # B3's HierTied rows, one cluster at a time, against the dense
        # density in float64
        lp64 = model.log_predictive(cast_floats(st, torch.float64),
                                    xs.double(), backend='torch')
        ok_64, e_64 = allclose_report(lp_k, lp64, 1e-5, 1e-4)
        # the joint M*K draw: 3 sweeps from the same generator, whose
        # Philox labels the plain twin draws alike
        g_k = model.fit_gibbs_fused(xs, key=2, maxiter=3, backend='kernel')
        g_t = model.fit_gibbs_fused(xs, key=2, maxiter=3, backend='torch')
        mis_g = float((g_k.labels != g_t.labels).double().mean())
        print(f'{tag} vs plain on 100,003 points: VI ELBO max|err| '
              f'{e_v:.6g} (rtol 1e-4) {"ok" if ok_v else "FAIL"}; '
              f'log_predictive max|err| {e_p:.6g} (rtol 1e-5, atol 1e-4) '
              f'{"ok" if ok_p else "FAIL"}, vs the dense density in '
              f'float64 {e_64:.6g} {"ok" if ok_64 else "FAIL"}; Gibbs 3 '
              f'sweeps: outer label mismatch {mis_g:.3g} (<= 1e-4)')
        check(ok_v and ok_p and ok_64 and mis_g <= 1e-4,
              f'{tag}: kernel path disagrees with the plain path')
        vi = rate(sweeps, lambda: model.fit_vi_fused(x, key=0,
                                                     maxiter=sweeps), reps=2)
        gibbs = rate(sweeps, lambda: model.fit_gibbs_fused(
            x, key=3, maxiter=sweeps), reps=2)
        print(f'rates on {card}, {tag}: VI {vi} it/s ({sweeps} sweeps from '
              f'the random start); Gibbs {gibbs} sweeps/s')

        spec = model._flat_spec()
        th_vi, _ = pad_theta(spec.theta(st.components),
                             model._flat_log_pi(st), torch.float32)
        th_g, _ = pad_theta(
            spec.theta_plugin(vmap(model.family.mode_params)(gs.components)),
            model._log_mix_weights(gs).reshape(-1), torch.float32)
        thq, aux = model._predictive_rows(st)
        plugin_slice_check(f'{tag} final VI theta', xt, th_vi,
                           cuda_estep.GAUSS, 0)
        precision_check(f'{tag} final VI theta (M*K={mk})', xt, th_vi, n)
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        labels, acc = gibbs_labels_check(f'B2 {tag} final Gibbs theta', xt,
                                         th_g, zero, n)
        pairs = {
            f'B1-nested{label}': (
                lambda: cuda_estep.estep(xt, th_vi, n),
                lambda: cuda_estep.estep_plain(xt, th_vi, n), None),
            f'B2-nested{label}': (
                lambda: cuda_gibbs.gibbs(xt, th_g, zero, n),
                lambda: cuda_gibbs.gibbs_plain(xt, th_g, zero, n),
                lambda: gibbs_acc_err(xt, n, cuda_estep.GAUSS, 0, labels,
                                      acc)),
            f'B3-nested{label}': (
                lambda: cuda_predict.predict(xt, thq, aux, n),
                lambda: cuda_predict.predict_plain(xt, thq, aux, n), None),
        }
        WORK[f'B1-nested{label}'] = estep_work(n, mk, m, 2)
        WORK[f'B2-nested{label}'] = gibbs_work(xt, th_g, n, m)
        WORK[f'B3-nested{label}'] = density_work(
            n, mk, quad_fmas(2), 2, 2, products=point_products(2))
        time_pairs(card, f'N={n} M*K={mk} d=2 ({tag})', pairs, errs, ms)
        del model, st, gs, lp
    del x, xt, xs
    torch.cuda.empty_cache()


def nested_plugin_paths(dev, seed, card, errs, launches, ms):
    """Cell 3 of phase 18: nested MAP-EM and ML-EM at N=1e7 (bench.py:
    385-398) through B1 with plug-in theta at M*K = 32 rows, by phase 17's
    checks (the peak device memory of each fit among them)."""
    kg = torch.Generator(device=dev).manual_seed(seed + 12)
    x = nested_blobs(kg, N_NEST_MAP, dev)
    model = BayesianMixtureOfMixtures.make_gmm(
        M_NEST, K_NEST, 2, hierarchical=False, kappa=0.5, psi_scale=0.5,
        device=dev)
    plugin_paths(card, f'nested MAP/EM N={N_NEST_MAP} M={M_NEST} '
                 f'K={K_NEST} d=2', model, (x,), 20,
                 ('B1-nested-MAP', 'B1-nested-EM'), 'B1', cuda_estep.GAUSS,
                 0, N_NEST_MAP, errs, launches, ms)
    del x, model
    torch.cuda.empty_cache()


def nested_ilr_paths(dev, seed, card, errs, launches, ms):
    """Cells 4 and 5 of phase 18: nested ILR serving (bench.py:400-420,
    the sine of bench.py:338-356; M=2, K=6, d=1, p=1) through B5 and the
    nested p=2 config of tests/test_pallas.py:474-499 (M=2, K=4) through
    B6, each fitted by a dense engine on a head of the data (p=2: VI 30;
    the sine: Gibbs 30, whose draws break the symmetric start that
    bench.py's dense VI 30 leaves the experts near, RMSE ~0.67 in
    mimo_tpu too); then the sine's
    fused VI over the first 1e6 points through B1's ILR map at M*K = 12
    rows with its precision line."""
    for count, n, n_fit, p, k, kappa, engine in (
            ('B5', N_NEST_ILR, N_NEST_ILR_FIT, 1, 6, 0.05, 'fit_gibbs'),
            ('B6', N_NEST_P2, N_NEST_P2_FIT, 2, 4, 0.1, 'fit_vi')):
        name, mk = f'{count}-nested', 2 * k
        kg = torch.Generator(device=dev).manual_seed(seed + 5)
        if p == 1:
            x = torch.rand((n, 1), generator=kg, device=dev) * 12 - 6
            y = torch.sin(x) + 0.1 * torch.randn((n, 1), generator=kg,
                                                 device=dev)
        else:
            x = torch.rand((n, 1), generator=kg, device=dev) * 6 - 3
            y = torch.cat([torch.sin(x), torch.cos(x)], -1) + 0.1 * \
                torch.randn((n, 2), generator=kg, device=dev)
        tag = (f'nested ILR ({"sine" if p == 1 else "sin/cos"}) N={n} M=2 '
               f'K={k} d=1 p={p}')
        model = BayesianMixtureOfMixtures.make_ilr(2, k, 1, p, kappa=kappa,
                                                   device=dev)

        def path():
            head = (x[:n_fit], y[:n_fit])
            model.init_transform(*head)
            if engine == 'fit_gibbs':
                gs = model.fit_gibbs(head, key=2, maxiter=30, maxsubiter=2)
                st = HMixState(gs.outer_gating, gs.inner_gating,
                               gs.components)
            else:
                st, _ = model.fit_vi(head, key=2, maxiter=30, maxsubiter=2)
            return st, model.predict(st, x, y, dist='studentt')
        (st, (mu, var, _, nlpd)), counts, secs = nested_fit(
            f'{tag}: dense {engine} 30 on the first {n_fit}, predict', path,
            {count: 1})
        launches[name] = counts[count]
        rmse = float(torch.sqrt(torch.mean((mu - y) ** 2)))
        print(f'{tag}: RMSE {rmse:.6g} (noise floor 0.1'
              + (', < 0.25' if p == 1 else '') + f'), mean NLPD '
              f'{float(nlpd.mean()):.6g} nats, original units; {secs:.4g} s '
              f'on {card} (fit and predict)')
        check(mu.shape == (n, p) and var.shape == (n, p)
              and nlpd.shape == (n,) and all_finite((st, mu, var, nlpd)),
              f'{tag}: predict not finite or of the wrong shape')
        if p == 1:
            check(rmse < 0.25, f'{tag}: RMSE {rmse} >= 0.25')
        xs, ys = x[:100_003], y[:100_003]
        got = model.predict(st, xs, ys, dist='studentt', backend='kernel')
        want = model.predict(st, xs, ys, dist='studentt', backend='torch')
        scale = float(model.output_transform.scale.max())
        oks, es = [], []
        for g, w, (rtol, atol) in zip(
                (got[0], got[1], got[3]), (want[0], want[1], want[3]),
                ((1e-4, 1e-4 * scale), (2e-3, 1e-4 * scale ** 2),
                 (1e-3, 2e-3))):
            ok, e = allclose_report(g, w, rtol, atol)
            oks.append(ok)
            es.append(e)
        print(f'{tag} predict vs the dense path on 100,003 points: '
              f'mean/var/nlpd max|err| {es[0]:.6g}/{es[1]:.6g}/{es[2]:.6g} '
              f'{"ok" if all(oks) else "FAIL"}')
        check(all(oks), f'{tag}: kernel path disagrees with the dense path')
        pred = rate(n, lambda: model.predict(st, x, y, dist='studentt'),
                    reps=3)
        print(f'rates on {card}, {tag}: predict {pred} pts/s')

        basis, experts = _flatten_mk(st.components)
        log_w = model._log_mix_weights(st).reshape(-1)
        xt = stack_rows(kernel_xts(
            (model._tx(x), model.output_transform.transform(y))))
        moments = [('rel', f'mean{j}' if p > 1 else 'mean') for j in range(p)]
        moments += [('rel', f'var{j}' if p > 1 else 'var') for j in range(p)]
        rows = moments + [('nats', 'nlpd'), ('nats', 'lse_w')]
        if p == 1:
            th, aux = cuda_ilr_predict.ilr_predict_coefficients(
                basis, experts, log_w)
            kern = lambda: cuda_ilr_predict.ilr_predict(  # noqa: E731
                xt, th, aux, n, True, False)
            plain = lambda: cuda_ilr_predict.ilr_predict_plain(  # noqa: E731
                xt, th, aux, n, True, False)
            serving_precision_cells(
                name, cuda_ilr_predict.ilr_predict,
                cuda_ilr_predict.ilr_predict_plain, xt, th,
                (aux, n, True, False), rows, 1, slice(0, mk))
        else:
            th, aux, vc = cuda_ilr_predict.ilr_p_predict_coefficients(
                basis, experts, log_w)
            kern = lambda: cuda_ilr_predict.ilr_p_predict(  # noqa: E731
                xt, th, aux, vc, n, p, True, False)
            plain = lambda: cuda_ilr_predict.ilr_p_predict_plain(  # noqa: E731
                xt, th, aux, vc, n, p, True, False)
            serving_precision_cells(
                name, cuda_ilr_predict.ilr_p_predict,
                cuda_ilr_predict.ilr_p_predict_plain, xt, th,
                (aux, vc, n, p, True, False), rows, 1, slice(0, mk), p=p)
        ok, e, flips = compare_serving(kern(), plain(), p, False)
        print(f'{name} vs plain at N={n}: max|err| {e:.6g} ({flips} points '
              f'off the serving tolerances) {"ok" if ok else "FAIL"}')
        check(ok, f'{name} disagrees with its plain version')
        WORK[name] = serving_work(n, mk, 1, p)
        time_pairs(card, f'N={n} M*K={mk} d=1 p={p} ({tag})',
                   {name: (kern, plain, lambda e=e: e)}, errs, ms)

        if p == 1:      # the fused VI over the ILR map at M*K = 12 rows
            n1 = 1_000_000
            data = (x[:n1], y[:n1])
            (st1, vlb), path, _ = nested_fit(
                f'{tag}: fit_vi_fused 20 on the first {n1}',
                lambda: model.fit_vi_fused(data, key=1, maxiter=20),
                {'B1-ILR': 20})
            launches['B1-ILR-nested'] = path['B1-ILR']
            elbo_report(f'{tag} fused VI N={n1}', vlb)
            check(all_finite(st1), f'{tag}: fused VI state not finite')
            sl = (x[:100_003], y[:100_003])
            _, v_k = model.fit_vi_fused(sl, key=1, maxiter=5,
                                        backend='kernel')
            _, v_t = model.fit_vi_fused(sl, key=1, maxiter=5,
                                        backend='torch')
            ok_v, e_v = allclose_report(v_k, v_t, 1e-4, 0.0)
            print(f'{tag} fused VI vs plain on 100,003 points: ELBO max|err| '
                  f'{e_v:.6g} (rtol 1e-4) {"ok" if ok_v else "FAIL"}')
            check(ok_v, f'{tag}: fused VI kernel path disagrees with plain')
            x1 = stack_rows(kernel_xts(model._tx_data(data)))
            th1, _ = pad_theta(model._flat_spec().theta(st1.components),
                               model._flat_log_pi(st1), torch.float32)
            plugin_slice_check(f'{tag} final VI theta, ILR map', x1, th1,
                               ILR, 1)
            precision_check(f'nested ILR N={n1} M*K={mk} d=1 p=1 final VI '
                            f'theta', x1, th1, n1, ILR, 1)
            WORK['B1-ILR-nested'] = estep_work(
                n1, mk, cuda_estep.feature_width(ILR, 1, 1), 2)
            time_pairs(card, f'N={n1} M*K={mk} d=1 p=1 ({tag}, fused VI)',
                       {'B1-ILR-nested': (
                           lambda: cuda_estep.estep(x1, th1, n1, ILR, 1),
                           lambda: cuda_estep.estep_plain(x1, th1, n1, ILR,
                                                          1), None)},
                       errs, ms)
            del st1, x1
        del x, y, model, st, mu, var, nlpd, xt
        torch.cuda.empty_cache()


def nested_dense_paths(dev, seed, card):
    """Cell 6 of phase 18: the dense nested engines (plain PyTorch, as in
    JAX) on the first 1e5 points of cell 1's data: no kernel launched."""
    kg = torch.Generator(device=dev).manual_seed(seed + 11)
    x = nested_blobs(kg, N_NEST, dev)[:N_NEST_DENSE]
    model = BayesianMixtureOfMixtures.make_gmm(
        M_NEST, K_NEST, 2, hierarchical=False, kappa=0.5, psi_scale=0.5,
        device=dev)
    tag = (f'nested dense N={N_NEST_DENSE} M={M_NEST} K={K_NEST} d=2 '
           f'(cell 1 data, cut)')
    dense = (
        ('fit_vi 10', 10, lambda: model.fit_vi(x, key=1, maxiter=10)),
        ('fit_map 10', 10, lambda: model.fit_map(x, key=1, maxiter=10)),
        ('fit_em 10', 10, lambda: model.fit_em(x, key=0, maxiter=10)),
        ('fit_gibbs 10', 10, lambda: model.fit_gibbs(x, key=2, maxiter=10)),
        ('fit_svi 100 B=256', 100, lambda: model.fit_svi(
            x, key=5, maxiter=100, step_size=0.5, batch_size=256)))
    torch.cuda.synchronize()
    reset_counts()
    for name, steps, fit in dense:
        t0 = time.perf_counter()
        out = fit()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        check(all_finite(out), f'{tag} {name} not finite')
        print(f'{tag} {name}: finite; one run on {card} '
              f'{steps / secs:.6g} steps/s')
    path = read_counts()
    print(f'{tag}: launches {path} (none: the dense engines are plain)')
    check(sum(path.values()) == 0, 'a dense nested engine launched a kernel')
    del x, model
    torch.cuda.empty_cache()


def nested_paths(dev, seed, card, errs, launches, ms):
    """Phase 18: the nested mixtures of mixtures at the repo's nested
    widths."""
    nested_gmm_paths(dev, seed, card, errs, launches, ms)
    nested_plugin_paths(dev, seed, card, errs, launches, ms)
    nested_ilr_paths(dev, seed, card, errs, launches, ms)
    nested_dense_paths(dev, seed, card)


# -- phase 19: chains -------------------------------------------------------

C_MAIN = 8                     # examples/chains_smc.py's default count
N_CHAIN16, K_CHAIN16, C_CHAIN16 = 100_000, 16, 16   # bench.py:421-439
N_TWOSAMPLE, S_TWOSAMPLE = 100_000, 256             # gibbs_twosample.py
N_CHUNK_CHAINS, K_CHUNK_CHAINS = 1_000_000, 300     # ROADMAP B-wide
N_SMC = 10_000                                      # examples/chains_smc.py
# chain row -> (its kernel's row, what the chains run)
CHAIN_ROWS = {
    'B1-chain': ('B1', f'C={C_MAIN} VI and MAP chains, N=1e7 K=50 d=2'),
    'B2-chain': ('B2', f'C={C_MAIN} Gibbs chains, N=1e7 K=50 d=2'),
    'B1-chain-16': ('B1', f'C={C_CHAIN16} VI chains, N=1e5 K=16 d=2'),
    'B2-chain-256': ('B2', f'S={S_TWOSAMPLE} sweeps of one theta (the '
                     'two-sample check), N=1e5 K=50 d=2'),
    'B1-chain-q8': ('B1-ILR', 'C=4 VI chains, N=1e6 K=50 d=8 p=1 m8=168'),
    'B1-chain-wide': ('B1', 'C=2 VI chains, streamed layout, N=1e6 K=300 '
                      'd=2'),
    'B2-chain-wide': ('B2', 'C=2 Gibbs chains, streamed layout, N=1e6 '
                      'K=300 d=2'),
    'B1-chain-nested': ('B1', f'C={C_MAIN} nested VI, MAP and ML-EM chains, '
                        'N=1e6 M*K=32 d=2'),
    'B2-chain-nested': ('B2', f'C={C_MAIN} nested Gibbs chains (joint M*K '
                        'draw), N=1e6 M*K=32 d=2'),
}


def chain_work(work, c, xt, n):
    """The work of C chains over shared points: C times the one-chain
    work, the points read once."""
    out = {u: c * v for u, v in work.items()}
    out['hbm'] -= (c - 1) * 4 * xt.shape[0] * n
    return out


def seconds(fn, reps=3):
    """Median wall seconds of fn() between synchronisations."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return statistics.median(out)


def chain_thetas(model, state, plugin=False):
    """(C, K, m8) f32 thetas of a C-stacked state: VI's posterior-expected
    theta (MFState) or the Gibbs plug-in theta (GibbsState)."""
    spec = model._estep_spec()
    if plugin:
        return pad_theta(vmap(spec.theta_plugin)(state.params), state.log_pi,
                         torch.float32)[0]
    return pad_theta(vmap(spec.theta)(state.components),
                     vmap(lambda g: g.expected_log_pi())(state.gating),
                     torch.float32)[0]


def chain_b1_checks(tag, xt, thetas, n, kind=cuda_estep.GAUSS, p=0,
                    f64_lines=False, phase3=False):
    """B1-chain at C thetas: each chain bitwise the one-chain launch at its
    theta (each chain has the one-chain grid along x); against the plain
    version on the first 100,003 points, statistics within 1e-5 of their
    summed magnitudes (+ 1e-6, phases 7 and 17), or with `phase3` at
    phase 3's rtol 1e-4 and atol 1e-3 per 1e6 points, lse within rtol
    1e-5; with `f64_lines` each chain's float64 line. Returns max |kernel - plain| on the slice."""
    c = thetas.shape[0]
    acc, lse = cuda_estep.estep(xt, thetas, n, kind, p)
    bitwise = True
    for i in range(c):
        a1, l1 = cuda_estep.estep(xt, thetas[i], n, kind, p)
        bitwise = bitwise and torch.equal(acc[i], a1) and torch.equal(lse[i],
                                                                      l1)
    ns = min(n, 100_003)
    xs = xt[:, :ns].contiguous()
    acc_s, lse_s = cuda_estep.estep(xs, thetas, ns, kind, p)
    pacc, plse = cuda_estep.estep_plain(xs, thetas, ns, kind, p)
    err = (acc_s.double() - pacc.double()).abs()
    mag = torch.stack([estep_magnitudes(xs, th, ns, kind, p)
                       for th in thetas])
    rel_s = float((err / mag.clamp(min=1e-30)).max())
    if phase3:
        atol = 1e-3 * ns / 1e6
        ok_s = bool((err <= atol + 1e-4 * pacc.double().abs()).all())
        rule = f'rtol 1e-4, atol {atol:.3g}'
    else:
        ok_s = bool((err <= 1e-5 * mag + 1e-6).all())
        rule = '1e-5 of the summed magnitudes'
    ok_l, err_l = allclose_report(lse_s, plse, 1e-5, 0.0)
    ok = bitwise and ok_s and ok_l
    print(f'B1-chain {tag}: {c} chains, each bitwise its one-chain launch '
          f'{bitwise}; vs plain on {ns} points: statistics max|err| '
          f'{float(err.max()):.6g}, of the summed magnitudes {rel_s:.3g} '
          f'({rule}) {"ok" if ok_s else "FAIL"}, lse '
          f'|err| {err_l:.6g} (rtol 1e-5) {"ok" if ok_l else "FAIL"}')
    check(ok, f'B1-chain {tag} disagrees')
    if f64_lines:
        for i in range(c):
            precision_check(f'{tag} chain {i}', xt, thetas[i], n, kind, p,
                            got=(acc[i], lse[i]))
    return float(err.max())


def chain_b2_checks(tag, xt, thetas, seeds, n, kind=cuda_estep.GAUSS, p=0):
    """B2-chain at C thetas and seeds: 0 labels differ from the one-chain
    launches, whose statistics are also bitwise the chain's; on the first
    100,003 points the
    labels equal the plain Philox labels (at most 1e-4 differ) and the
    statistics the one-hot sums of its own labels within 1e-5 of their
    summed magnitudes (phase 4's bounds). Returns max |acc - one-hot
    sums| on the slice."""
    c, k = thetas.shape[:2]
    labels, acc = cuda_gibbs.gibbs(xt, thetas, seeds, n, kind, p)
    differ, bitwise = 0, True
    for i in range(c):
        l1, a1 = cuda_gibbs.gibbs(xt, thetas[i], seeds[i], n, kind, p)
        differ += int((labels[i] != l1).sum())
        bitwise = bitwise and torch.equal(acc[i], a1)
    ns = min(n, 100_003)
    xs = xt[:, :ns].contiguous()
    lab_s, acc_s = cuda_gibbs.gibbs(xs, thetas, seeds, ns, kind, p)
    plab, _ = cuda_gibbs.gibbs_plain(xs, thetas, seeds, ns, kind, p)
    f = assemble_features(xs, thetas.shape[2], kind, p).double()
    worst, rel = 0.0, 0.0
    for i in range(c):
        oh = torch.nn.functional.one_hot(lab_s[i].long(), k).double()
        err = (acc_s[i].double() - oh.T @ f.T).abs()
        mag = (oh.T @ f.abs().T).clamp(min=1e-30)
        worst = max(worst, float(err.max()))
        rel = max(rel, float((err / mag).max()))
    mismatch = float((lab_s != plab).double().mean())
    ok = differ == 0 and bitwise and mismatch <= 1e-4 and rel <= 1e-5
    print(f'B2-chain {tag}: {c} chains; labels differing from the '
          f'one-chain launches {differ} (must be 0); statistics bitwise '
          f'the one-chain launches {bitwise}; on {ns} points: '
          f'label mismatch vs plain Philox {mismatch:.3g} (<= 1e-4), stats '
          f'vs one-hot sums of its labels max|err| / summed magnitude '
          f'{rel:.3g} (<= 1e-5) {"ok" if ok else "FAIL"}')
    check(ok, f'B2-chain {tag} disagrees')
    return worst


def time_chain(card, tag, name, c, kern, single, plain, ms, singles,
               plain_reps=(1, 1)):
    """A chain launch's time by CUDA events beside its C one-chain
    launches' summed time (`single(i)` launches chain i alone) and its
    plain version's (warm-ups and runs `plain_reps`)."""
    ms[name] = (cuda_ms(kern, 10),
                cuda_ms(plain, plain_reps[1], warm=plain_reps[0]))
    singles[name] = (c, cuda_ms(lambda: [single(i) for i in range(c)], 5))
    print(f'{name} time on {card} at {tag}: chain launch {ms[name][0]:.6g} '
          f'ms, {c} one-chain launches {singles[name][1]:.6g} ms, plain '
          f'PyTorch {ms[name][1]:.6g} ms')


def chain_main_cell(dev, seed, card, n_main, errs, launches, ms, singles):
    """Cell 1 of phase 19: phase 6's DP-GMM by fit_chains over C_MAIN
    keys. Returns the data (for cells 2 and 3) and the model."""
    kg = torch.Generator(device=dev).manual_seed(seed)
    mu = torch.randn((3, D_MAIN), generator=kg, device=dev) * 4.0
    lm = torch.eye(D_MAIN, device=dev).expand(3, D_MAIN, D_MAIN) * 2.0
    x, _ = BayesianGMM.generate(kg, GaussParams(mu, lm), [.3, .4, .3],
                                n_main)
    model = BayesianGMM.make(size=K_MAIN, dim=D_MAIN, gating='dp', alpha=1.0,
                             kappa=0.05, psi_scale=0.5, device=dev)
    keys = list(range(1, C_MAIN + 1))
    tag = f'chains N={n_main} K={K_MAIN} d={D_MAIN} C={C_MAIN}'
    peaks, counts = {}, {}

    def fit(engine):
        torch.cuda.reset_peak_memory_stats()
        out = fit_chains(model, engine, x, keys, maxiter=20)
        torch.cuda.synchronize()
        peaks[engine] = torch.cuda.max_memory_allocated()
        counts[engine] = read_counts()
        return out

    torch.cuda.synchronize()
    reset_counts()
    st, vlb = fit('fit_vi_fused')
    gs = fit('fit_gibbs_fused')
    mst, mll = fit('fit_map_fused')
    best, idx = best_of(st, vlb)
    summary = diagnostics(vlb)
    lp = model.log_predictive(best, x)
    torch.cuda.synchronize()
    path = read_counts()
    launches.update({'B1-chain': path['B1'], 'B2-chain': path['B2']})
    print(f'{tag}: launches after VI {counts["fit_vi_fused"]}, after Gibbs '
          f'{counts["fit_gibbs_fused"]}, after MAP {counts["fit_map_fused"]}, '
          f'after log_predictive {path}')
    n_after = [sum(counts[e].values()) for e in
               ('fit_vi_fused', 'fit_gibbs_fused', 'fit_map_fused')]
    check(counts['fit_vi_fused']['B1'] == 20 and n_after == [20, 40, 60]
          and counts['fit_gibbs_fused']['B2'] == 20 and path['B1'] == 40
          and path['B3'] == 1 and sum(path.values()) == 61,
          f'{tag}: B1 / B2 not launched once a sweep for all chains')
    v = vlb.double()
    drop = float(((v[:, :-1] - v[:, 1:]) / v[:, 1:].abs()).max())
    check(vlb.shape == (C_MAIN, 20) and bool(torch.isfinite(v).all())
          and drop <= 1e-4, f'{tag}: VI traces not finite or falling')
    check(all_finite(gs[:4]) and gs.labels.shape == (C_MAIN, n_main)
          and int(gs.labels.min()) >= 0 and int(gs.labels.max()) < K_MAIN
          and bool(torch.isfinite(mll).all()) and all_finite(mst),
          f'{tag}: Gibbs or MAP chains not finite')
    check(lp.shape == (n_main,) and bool(torch.isfinite(lp).all()),
          f'{tag}: log_predictive of the best chain not finite')
    print(f'{tag}: final ELBOs {[round(float(e), 1) for e in vlb[:, -1]]}, '
          f'worst relative drop {drop:.3g} (<= 1e-4); best_of chain '
          f'{int(idx)}; diagnostics of the VI traces {summary}; Gibbs '
          f'labels {tuple(gs.labels.shape)}; MAP final logliks '
          f'{[round(float(e), 1) for e in mll[:, -1]]}; mean log predictive '
          f'of the best chain {float(lp.mean()):.6g}; peak device memory '
          + ', '.join(f'{e} {b / 2**30:.4g} GiB' for e, b in peaks.items()))

    # the kernels at the chains' final thetas
    xt = kernel_xts((x,))[0]
    th_vi = chain_thetas(model, st)
    th_g = chain_thetas(model, gs, plugin=True)
    gen = torch.Generator(device=dev).manual_seed(seed + 19)
    seeds = torch.randint(0, 2 ** 62, (C_MAIN,), generator=gen, device=dev)
    errs['B1-chain'] = chain_b1_checks(tag, xt, th_vi, n_main,
                                       f64_lines=True, phase3=True)
    errs['B2-chain'] = chain_b2_checks(tag, xt, th_g, seeds, n_main)

    # same keys, same chains; each VI chain against its serial fit
    _, vlb2 = fit_chains(model, 'fit_vi_fused', x, keys, maxiter=20)
    worst = 0.0
    for i, k in enumerate(keys):
        _, v1 = model.fit_vi_fused(x, key=k, maxiter=20)
        worst = max(worst, float(((vlb[i] - v1).abs() / v1.abs()).max()))
    print(f'{tag}: fit_chains repeated with the same keys: traces equal '
          f'{torch.equal(vlb, vlb2)}; each chain vs fit_vi_fused with its '
          f'key: max relative trace difference {worst:.3g} (<= 1e-5)')
    check(torch.equal(vlb, vlb2) and worst <= 1e-5,
          f'{tag}: chains not repeatable or off their serial fits')

    # rates: C chains against one fit, warm-started VI and Gibbs
    t_vi = (seconds(lambda: fit_chains(model, 'fit_vi_fused', x, keys,
                                       maxiter=20, init_state=st,
                                       randomize=False)),
            seconds(lambda: model.fit_vi_fused(
                x, maxiter=20, init_state=best, randomize=False)))
    t_g = (seconds(lambda: fit_chains(model, 'fit_gibbs_fused', x, keys,
                                      maxiter=20)),
           seconds(lambda: model.fit_gibbs_fused(x, key=1, maxiter=20)))
    for eng, (tc, t1) in (('VI (warm-started)', t_vi), ('Gibbs', t_g)):
        print(f'rates on {card}, {tag}: {eng} 20 sweeps: {C_MAIN} chains '
              f'{tc:.6g} s ({20 * C_MAIN / tc:.6g} chain-sweeps/s), one fit '
              f'{t1:.6g} s ({20 / t1:.6g} sweeps/s); aggregate speedup '
              f'C t1 / tC {C_MAIN * t1 / tc:.4g} (median of 3)')

    m = cuda_estep.feature_width(cuda_estep.GAUSS, D_MAIN)
    WORK['B1-chain'] = chain_work(estep_work(n_main, K_MAIN, m, D_MAIN),
                                  C_MAIN, xt, n_main)
    work = [gibbs_work(xt, th_g[i], n_main, m) for i in range(C_MAIN)]
    WORK['B2-chain'] = {u: sum(w[u] for w in work) for u in work[0]}
    WORK['B2-chain']['hbm'] -= (C_MAIN - 1) * 4 * D_MAIN * n_main
    time_chain(card, tag, 'B1-chain', C_MAIN,
               lambda: cuda_estep.estep(xt, th_vi, n_main),
               lambda i: cuda_estep.estep(xt, th_vi[i], n_main),
               lambda: cuda_estep.estep_plain(xt, th_vi, n_main), ms,
               singles, (1, 2))
    time_chain(card, tag, 'B2-chain', C_MAIN,
               lambda: cuda_gibbs.gibbs(xt, th_g, seeds, n_main),
               lambda i: cuda_gibbs.gibbs(xt, th_g[i], seeds[i], n_main),
               lambda: cuda_gibbs.gibbs_plain(xt, th_g, seeds, n_main), ms,
               singles, (0, 1))
    del st, gs, mst, best, lp, th_vi, th_g
    return x, model


def chain_bench_cell(x, card, errs, launches, ms, singles):
    """Cell 2 of phase 19, bench.py:421-439: the first 1e5 points, K=16,
    16 chains of fit_vi_fused 50 against one fit."""
    xs = x[:N_CHAIN16].contiguous()
    model = BayesianGMM.make(size=K_CHAIN16, dim=D_MAIN, gating='dp',
                             alpha=1.0, kappa=0.05, psi_scale=0.5,
                             device=x.device)
    keys = list(range(1, C_CHAIN16 + 1))
    tag = f'chains N={N_CHAIN16} K={K_CHAIN16} C={C_CHAIN16} (bench.py:421)'
    torch.cuda.synchronize()
    reset_counts()
    st, vlb = fit_chains(model, 'fit_vi_fused', xs, keys, maxiter=50)
    torch.cuda.synchronize()
    path = read_counts()
    launches['B1-chain-16'] = path['B1']
    print(f'{tag}: launches {path}')
    check(path['B1'] == 50 and sum(path.values()) == 50,
          f'{tag}: B1 not launched once a sweep for all chains')
    check(bool(torch.isfinite(vlb).all()), f'{tag}: VI traces not finite')
    t1 = seconds(lambda: model.fit_vi_fused(xs, key=1, maxiter=50))
    t16 = seconds(lambda: fit_chains(model, 'fit_vi_fused', xs, keys,
                                     maxiter=50))
    print(f'rates on {card}, {tag}: fit_vi_fused 50: 1 restart {t1:.6g} s, '
          f'{C_CHAIN16} chains {t16:.6g} s; aggregate speedup C t1 / tC '
          f'{C_CHAIN16 * t1 / t16:.4g} (median of 3, inits included)')
    xt = kernel_xts((xs,))[0]
    th = chain_thetas(model, st)
    errs['B1-chain-16'] = chain_b1_checks(tag, xt, th, N_CHAIN16)
    m = cuda_estep.feature_width(cuda_estep.GAUSS, D_MAIN)
    WORK['B1-chain-16'] = chain_work(
        estep_work(N_CHAIN16, K_CHAIN16, m, D_MAIN), C_CHAIN16, xt, N_CHAIN16)
    time_chain(card, tag, 'B1-chain-16', C_CHAIN16,
               lambda: cuda_estep.estep(xt, th, N_CHAIN16),
               lambda i: cuda_estep.estep(xt, th[i], N_CHAIN16),
               lambda: cuda_estep.estep_plain(xt, th, N_CHAIN16), ms,
               singles, (1, 3))


def chain_twosample_cell(x, model, seed, card, errs, launches, ms, singles):
    """Cell 3 of phase 19, the fixed-state two-sample check of B2
    (scripts/gibbs_twosample.py): one state from a short fused Gibbs run
    on the first 1e5 points, S label sweeps of it as S chains of B2."""
    xs = x[:N_TWOSAMPLE].contiguous()
    gs = model.fit_gibbs_fused(xs, key=3, maxiter=20)
    theta, _ = pad_theta(model._estep_spec().theta_plugin(gs.params),
                         gs.log_pi, torch.float32)
    xt = kernel_xts((xs,))[0]
    seeds = (2000 + seed * S_TWOSAMPLE
             + torch.arange(S_TWOSAMPLE, dtype=torch.int64, device=x.device))
    tag = f'two-sample N={N_TWOSAMPLE} K={K_MAIN} S={S_TWOSAMPLE}'
    torch.cuda.synchronize()
    reset_counts()
    stats, labels = precision.fixed_state_check(xt, theta, seeds,
                                                N_TWOSAMPLE)
    torch.cuda.synchronize()
    path = read_counts()
    launches['B2-chain-256'] = path['B2']
    check(path['B2'] == 1 and sum(path.values()) == 1,
          f'{tag}: the S sweeps were not one B2 launch')
    for name, st in stats.items():
        print(f'{tag} vs the {name} expectation: {st["live"]} live '
              f'components (expected count > 5), max |z| '
              f'{st["max_z"]:.4g} (<= {precision.MAX_Z}), chi^2/df '
              f'{st["chi2_df"]:.4g} (<= {precision.MAX_CHI2_DF}), '
              f'variance ratio {st["var_ratio"]:.4g} (in '
              f'{list(precision.VAR_RATIO)}) '
              f'{"ok" if precision.passes(st) else "FAIL"}')
        check(precision.passes(st), f'{tag}: B2 off the {name} expectation')
    thetas = theta.expand((S_TWOSAMPLE,) + theta.shape).contiguous()
    lab_c, acc_c = cuda_gibbs.gibbs(xt, thetas, seeds, N_TWOSAMPLE)
    probe = (0, 7, S_TWOSAMPLE - 1)
    same = all(torch.equal(lab_c[i], cuda_gibbs.gibbs(
        xt, theta, seeds[i], N_TWOSAMPLE)[0]) for i in probe)
    errs['B2-chain-256'] = max(gibbs_acc_err(
        xt, N_TWOSAMPLE, cuda_estep.GAUSS, 0, lab_c[i], acc_c[i])
        for i in probe)
    print(f'{tag}: sweeps {probe} equal their one-chain launches '
          f'{same}; statistics vs one-hot sums of their labels max|err| '
          f'{errs["B2-chain-256"]:.6g}')
    check(same and torch.equal(lab_c, labels),
          f'{tag}: a sweep differs from its one-chain launch')
    m = cuda_estep.feature_width(cuda_estep.GAUSS, D_MAIN)
    WORK['B2-chain-256'] = chain_work(gibbs_work(xt, theta, N_TWOSAMPLE, m),
                                      S_TWOSAMPLE, xt, N_TWOSAMPLE)
    time_chain(card, tag, 'B2-chain-256', S_TWOSAMPLE,
               lambda: cuda_gibbs.gibbs(xt, thetas, seeds, N_TWOSAMPLE),
               lambda i: cuda_gibbs.gibbs(xt, theta, seeds[i], N_TWOSAMPLE),
               lambda: cuda_gibbs.gibbs_plain(xt, thetas, seeds,
                                              N_TWOSAMPLE), ms, singles)


def chain_layout_cells(dev, seed, x, card, errs, launches, ms, singles):
    """Cell 4 of phase 19: B1-chain over the q8 ILR map (N=1e6, m8=168,
    C=4) and B1/B2-chain in the streamed layout (K=300, d=2, N=1e6, C=2),
    each after a short fit_chains that launches it, checked against its
    one-chain launches at the final thetas."""
    kg = torch.Generator(device=dev).manual_seed(seed + 3)
    xq, yq = regression_data(kg, N_Q8, D_Q8, 1, dev)
    mq = BayesianILR.make(size=K_MAIN, input_dim=D_Q8, output_dim=1,
                          alpha=2.0, kappa=0.05, device=dev)
    tag = f'q8 N={N_Q8} K={K_MAIN} d={D_Q8} p=1 C=4'
    torch.cuda.synchronize()
    reset_counts()
    st, vlb = fit_chains(mq, 'fit_vi_fused', (xq, yq), [1, 2, 3, 4],
                         maxiter=5)
    torch.cuda.synchronize()
    path = read_counts()
    launches['B1-chain-q8'] = path['B1-ILR']
    print(f'{tag}: fit_chains VI 5 launches {path}')
    check(path['B1-ILR'] == 5 and sum(path.values()) == 5
          and bool(torch.isfinite(vlb).all()), f'{tag}: B1 not launched once '
          'a sweep for all chains, or the traces not finite')
    xt = stack_rows(kernel_xts((xq, yq)))
    th = chain_thetas(mq, st)
    errs['B1-chain-q8'] = chain_b1_checks(tag, xt, th, N_Q8, ILR, 1,
                                          f64_lines=True)
    m = cuda_estep.feature_width(ILR, D_Q8, 1)
    WORK['B1-chain-q8'] = chain_work(estep_work(N_Q8, K_MAIN, m, D_Q8 + 1),
                                     4, xt, N_Q8)
    time_chain(card, tag, 'B1-chain-q8', 4,
               lambda: cuda_estep.estep(xt, th, N_Q8, ILR, 1),
               lambda i: cuda_estep.estep(xt, th[i], N_Q8, ILR, 1),
               lambda: cuda_estep.estep_plain(xt, th, N_Q8, ILR, 1), ms,
               singles, (1, 2))
    del xq, yq, xt, st

    xw = x[:N_CHUNK_CHAINS].contiguous()
    mw = BayesianGMM.make(size=K_CHUNK_CHAINS, dim=D_MAIN, gating='dp',
                          alpha=1.0, kappa=0.05, psi_scale=0.5, device=dev)
    tag = f'streamed layout N={N_CHUNK_CHAINS} K={K_CHUNK_CHAINS} d=2 C=2'
    torch.cuda.synchronize()
    reset_counts()
    st, vlb = fit_chains(mw, 'fit_vi_fused', xw, [1, 2], maxiter=3)
    gs = fit_chains(mw, 'fit_gibbs_fused', xw, [1, 2], maxiter=3)
    torch.cuda.synchronize()
    path = read_counts()
    launches.update({'B1-chain-wide': path['B1'],
                     'B2-chain-wide': path['B2']})
    print(f'{tag}: fit_chains VI 3 and Gibbs 3 launches {path}')
    check(path['B1'] == 3 and path['B2'] == 3 and sum(path.values()) == 6
          and bool(torch.isfinite(vlb).all()) and all_finite(gs[:4]),
          f'{tag}: B1 / B2 not launched once a sweep for all chains')
    xt = kernel_xts((xw,))[0]
    th_vi = chain_thetas(mw, st)
    th_g = chain_thetas(mw, gs, plugin=True)
    seeds = torch.tensor([11, 2 ** 50 + 7], dtype=torch.int64, device=dev)
    errs['B1-chain-wide'] = chain_b1_checks(tag, xt, th_vi, N_CHUNK_CHAINS)
    errs['B2-chain-wide'] = chain_b2_checks(tag, xt, th_g, seeds,
                                            N_CHUNK_CHAINS)
    m = cuda_estep.feature_width(cuda_estep.GAUSS, D_MAIN)
    WORK['B1-chain-wide'] = chain_work(
        estep_work(N_CHUNK_CHAINS, K_CHUNK_CHAINS, m, D_MAIN), 2, xt,
        N_CHUNK_CHAINS)
    work = [gibbs_work(xt, th_g[i], N_CHUNK_CHAINS, m) for i in range(2)]
    WORK['B2-chain-wide'] = {u: work[0][u] + work[1][u] for u in work[0]}
    WORK['B2-chain-wide']['hbm'] -= 4 * D_MAIN * N_CHUNK_CHAINS
    time_chain(card, tag, 'B1-chain-wide', 2,
               lambda: cuda_estep.estep(xt, th_vi, N_CHUNK_CHAINS),
               lambda i: cuda_estep.estep(xt, th_vi[i], N_CHUNK_CHAINS),
               lambda: cuda_estep.estep_plain(xt, th_vi, N_CHUNK_CHAINS), ms,
               singles, (1, 2))
    time_chain(card, tag, 'B2-chain-wide', 2,
               lambda: cuda_gibbs.gibbs(xt, th_g, seeds, N_CHUNK_CHAINS),
               lambda i: cuda_gibbs.gibbs(xt, th_g[i], seeds[i],
                                          N_CHUNK_CHAINS),
               lambda: cuda_gibbs.gibbs_plain(xt, th_g, seeds,
                                              N_CHUNK_CHAINS), ms, singles,
               (1, 2))


def chain_smc_cell(dev, seed, card):
    """Cell 5 of phase 19: smc_gibbs on examples/chains_smc.py's data and
    model (N=1e4, K=10, 8 chains, 8 rounds of 10 sweeps): the dense
    sweep, batched over the chains, no kernel."""
    kg = torch.Generator(device=dev).manual_seed(seed + 5)
    mu = torch.tensor([[-4., 0.], [4., 0.], [0., 5.]], device=dev)
    lm = torch.eye(2, device=dev).expand(3, 2, 2) * 2.0
    x, _ = BayesianGMM.generate(kg, GaussParams(mu, lm), [.3, .4, .3], N_SMC)
    model = BayesianGMM.make(size=10, dim=2, gating='dp', kappa=0.05,
                             psi_scale=0.5, device=dev)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    states, lls = smc_gibbs(model, x, key=seed, n_chains=C_MAIN, n_rounds=8,
                            sweeps_per_round=10)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    path = read_counts()
    print(f'smc_gibbs N={N_SMC} K=10 {C_MAIN} chains, 8 rounds x 10 sweeps: '
          f'per-round mean log-likelihoods '
          f'{[round(float(v), 2) for v in lls]}; labels '
          f'{tuple(states.labels.shape)}; launches {path} (none: the dense '
          f'sweep); one run on {card} {80 * C_MAIN / secs:.6g} '
          f'chain-sweeps/s')
    check(bool(torch.isfinite(lls).all()) and float(lls[-1]) >= float(lls[0])
          and states.labels.shape == (C_MAIN, N_SMC)
          and sum(path.values()) == 0,
          'smc_gibbs not finite, worse in its last round, or launched a '
          'kernel')


def chain_nested_cell(dev, seed, card, errs, launches, ms, singles):
    """Cell 6 of phase 19: phase 18's nested GMM (two blobs of 5e5, M=4,
    K=8, d=2, hierarchical=False) by fit_chains over C_MAIN keys: the
    fused engines batch the chains over M*K flat kernel rows, B1 / B2
    launched once a sweep for all chains."""
    kg = torch.Generator(device=dev).manual_seed(seed + 11)
    x = nested_blobs(kg, N_NEST, dev)
    n, mk = N_NEST, M_NEST * K_NEST
    model = BayesianMixtureOfMixtures.make_gmm(
        M_NEST, K_NEST, 2, hierarchical=False, kappa=0.5, psi_scale=0.5,
        maxsubiter=5, device=dev)
    keys = list(range(1, C_MAIN + 1))
    tag = f'nested chains N={n} M={M_NEST} K={K_NEST} d=2 C={C_MAIN}'
    sweeps = 20
    (st, vlb), path, t_vi = nested_fit(
        f'{tag} fit_vi_fused {sweeps}',
        lambda: fit_chains(model, 'fit_vi_fused', x, keys, maxiter=sweeps),
        {'B1': sweeps})
    n_b1 = path['B1']
    gs, path, t_g = nested_fit(
        f'{tag} fit_gibbs_fused {sweeps}',
        lambda: fit_chains(model, 'fit_gibbs_fused', x, keys,
                           maxiter=sweeps), {'B2': sweeps})
    launches['B2-chain-nested'] = path['B2']
    (mst, mll), path, t_m = nested_fit(
        f'{tag} fit_map_fused {sweeps}',
        lambda: fit_chains(model, 'fit_map_fused', x, keys, maxiter=sweeps),
        {'B1': sweeps})
    n_b1 += path['B1']
    (est, ell), path, t_e = nested_fit(
        f'{tag} fit_em_fused {sweeps}',
        lambda: fit_chains(model, 'fit_em_fused', x, keys, maxiter=sweeps),
        {'B1': sweeps})
    launches['B1-chain-nested'] = n_b1 + path['B1']
    best, idx = best_of(st, vlb)
    lp, _, _ = nested_fit(f'{tag} log_predictive of the best chain',
                          lambda: model.log_predictive(best, x), {'B3': 1})
    v = vlb.double()
    drop = float(((v[:, :-1] - v[:, 1:]) / v[:, 1:].abs()).max())
    check(vlb.shape == (C_MAIN, sweeps) and bool(torch.isfinite(v).all())
          and drop <= 1e-4, f'{tag}: VI traces not finite or falling')
    check(all_finite(gs[:3]) and gs.labels.shape == (C_MAIN, n)
          and int(gs.labels.min()) >= 0 and int(gs.labels.max()) < M_NEST
          and all_finite(mst) and all_finite(est)
          and bool(torch.isfinite(mll).all())
          and bool(torch.isfinite(ell).all()),
          f'{tag}: Gibbs, MAP or ML-EM chains not finite')
    check(lp.shape == (n,) and bool(torch.isfinite(lp).all()),
          f'{tag}: log_predictive of the best chain not finite')
    print(f'{tag}: final ELBOs {[round(float(e), 1) for e in vlb[:, -1]]}, '
          f'worst relative drop {drop:.3g} (<= 1e-4); best_of chain '
          f'{int(idx)}; MAP final logliks '
          f'{[round(float(e), 1) for e in mll[:, -1]]}; ML-EM '
          f'{[round(float(e), 1) for e in ell[:, -1]]}; mean log predictive '
          f'of the best chain {float(lp.mean()):.6g}; one run each on '
          f'{card}: VI {sweeps * C_MAIN / t_vi:.6g}, Gibbs '
          f'{sweeps * C_MAIN / t_g:.6g}, MAP {sweeps * C_MAIN / t_m:.6g}, '
          f'ML-EM {sweeps * C_MAIN / t_e:.6g} chain-sweeps/s (first calls)')

    # each VI chain against the nested fit with its key
    worst = 0.0
    for i, k in enumerate(keys):
        _, v1 = model.fit_vi_fused(x, key=k, maxiter=sweeps)
        worst = max(worst, float(((vlb[i] - v1).abs() / v1.abs()).max()))
    print(f'{tag}: each VI chain vs the nested fit_vi_fused with its key: '
          f'max relative trace difference {worst:.3g} (<= 1e-5)')
    check(worst <= 1e-5, f'{tag}: chains off their serial fits')

    # B1 / B2 with a chain axis at the chains' final thetas, M*K rows
    xt = kernel_xts((x,))[0]
    spec = model._flat_spec()
    th_vi = pad_theta(vmap(spec.theta)(st.components),
                      vmap(model._flat_log_pi)(st), torch.float32)[0]
    th_g = pad_theta(
        vmap(spec.theta_plugin)(vmap(vmap(model.family.mode_params))(
            gs.components)),
        vmap(model._log_mix_weights)(gs).flatten(1), torch.float32)[0]
    gen = torch.Generator(device=dev).manual_seed(seed + 23)
    seeds = torch.randint(0, 2 ** 62, (C_MAIN,), generator=gen, device=dev)
    errs['B1-chain-nested'] = chain_b1_checks(tag, xt, th_vi, n)
    errs['B2-chain-nested'] = chain_b2_checks(tag, xt, th_g, seeds, n)
    m = cuda_estep.feature_width(cuda_estep.GAUSS, 2)
    WORK['B1-chain-nested'] = chain_work(estep_work(n, mk, m, 2), C_MAIN,
                                         xt, n)
    work = [gibbs_work(xt, th_g[i], n, m) for i in range(C_MAIN)]
    WORK['B2-chain-nested'] = {u: sum(w[u] for w in work) for u in work[0]}
    WORK['B2-chain-nested']['hbm'] -= (C_MAIN - 1) * 4 * 2 * n
    time_chain(card, tag, 'B1-chain-nested', C_MAIN,
               lambda: cuda_estep.estep(xt, th_vi, n),
               lambda i: cuda_estep.estep(xt, th_vi[i], n),
               lambda: cuda_estep.estep_plain(xt, th_vi, n), ms, singles,
               (1, 2))
    time_chain(card, tag, 'B2-chain-nested', C_MAIN,
               lambda: cuda_gibbs.gibbs(xt, th_g, seeds, n),
               lambda i: cuda_gibbs.gibbs(xt, th_g[i], seeds[i], n),
               lambda: cuda_gibbs.gibbs_plain(xt, th_g, seeds, n), ms,
               singles, (0, 1))
    del x, xt, model, st, gs, mst, est, best, lp
    torch.cuda.empty_cache()


def chain_paths(dev, seed, card, n_main, errs, launches, ms):
    """Phase 19: multi-chain inference through B1 and B2 with a chain
    axis. Returns {chain row: (C, the C one-chain launches' summed ms)}."""
    singles = {}
    x, model = chain_main_cell(dev, seed, card, n_main, errs, launches, ms,
                               singles)
    chain_bench_cell(x, card, errs, launches, ms, singles)
    chain_twosample_cell(x, model, seed, card, errs, launches, ms, singles)
    chain_layout_cells(dev, seed, x, card, errs, launches, ms, singles)
    del x, model
    torch.cuda.empty_cache()
    chain_smc_cell(dev, seed, card)
    chain_nested_cell(dev, seed, card, errs, launches, ms, singles)
    return singles


# -- the Gaussian row of B3 (phase 6) ----------------------------------------

def gauss_predictive_row(model, st, x, xt, card, errs, launches, ms):
    """B3's moment-matched Gaussian variant at phase 6's VI state (N=1e7,
    K=50, d=2), launched once through log_predictive(dist='gaussian'),
    against its plain version and the one PyTorch call that computes the
    same function: MixtureSameFamily(Categorical(log_w),
    MultivariateNormal(mu, scale_tril=L)).log_prob in 1e6-point chunks."""
    n = x.shape[0]
    torch.cuda.synchronize()
    reset_counts()
    lg = model.log_predictive(st, x, dist='gaussian')
    torch.cuda.synchronize()
    launches['B3-gauss'] = read_counts()['B3']
    check(launches['B3-gauss'] == 1 and bool(torch.isfinite(lg).all()),
          'the Gaussian predictive bypassed B3 or is not finite')
    log_w = model.predictive_log_weights(st)
    thq, aux = cuda_predict.predictive_coefficients(st.components, log_w,
                                                    False)
    mu, lmbda, _ = predictive_studentt_params(st.components)
    mix = torch.distributions.MixtureSameFamily(
        torch.distributions.Categorical(logits=log_w),
        torch.distributions.MultivariateNormal(
            mu, scale_tril=torch.linalg.cholesky(torch.linalg.inv(lmbda))))

    def library():
        return torch.cat([mix.log_prob(x[s:s + 1_000_000])
                          for s in range(0, n, 1_000_000)])
    ok, errs['B3-gauss'] = allclose_report(
        lg, cuda_predict.predict_plain(xt, thq, aux, n, False), 1e-5, 1e-4)
    # the library call is timed once (it takes ~1e5 ms at N=1e7), and not
    # trusted: where it strays most, the same call in float64 says which
    # of the two is off
    out = []
    LIBRARY['B3-gauss'] = cuda_ms(lambda: out.append(library()), 1, warm=0)
    lib = out[0]
    dev_l = (lg.double() - lib.double()).abs()
    i = int(dev_l.argmax())
    mix64 = torch.distributions.MixtureSameFamily(
        torch.distributions.Categorical(logits=log_w.double()),
        torch.distributions.MultivariateNormal(
            mu.double(), scale_tril=torch.linalg.cholesky(
                torch.linalg.inv(lmbda.double()))))
    at_i = float(mix64.log_prob(x[i:i + 1].double())[0])
    print(f'B3 gaussian N={n} K={K_MAIN} d={D_MAIN} at the VI state: '
          f'launches 1; vs plain max|err| {errs["B3-gauss"]:.6g} nats '
          f'(rtol 1e-5, atol 1e-4) {"ok" if ok else "FAIL"}; '
          f'MixtureSameFamily(MultivariateNormal) in f32 strays up to '
          f'{float(dev_l[i]):.6g} nats, at point {i} {x[i].tolist()}: '
          f'kernel {float(lg[i]):.9g}, library {float(lib[i]):.9g}'
          f', library in float64 {at_i:.9g}; mean |deviation| '
          f'{float(dev_l.mean()):.3g}')
    check(ok, 'B3 gaussian disagrees')
    ms['B3-gauss'] = (
        cuda_ms(lambda: cuda_predict.predict(xt, thq, aux, n, False), 20),
        cuda_ms(lambda: cuda_predict.predict_plain(xt, thq, aux, n, False),
                3))
    WORK['B3-gauss'] = density_work(n, K_MAIN, quad_fmas(D_MAIN), D_MAIN, 1,
                                    products=point_products(D_MAIN))
    print(f'B3-gauss time on {card} at N={n} K={K_MAIN} d={D_MAIN}: kernel '
          f'{ms["B3-gauss"][0]:.6g} ms, plain PyTorch {ms["B3-gauss"][1]:.6g}'
          f' ms, MixtureSameFamily(MultivariateNormal) '
          f'{LIBRARY["B3-gauss"]:.6g} ms')


# -- phase 20: out-of-core ---------------------------------------------------

N_STREAM, B_SVI_STREAM, STEPS_SVI_STREAM = 2_000_000, 65536, 100  # bench.py:
B_VI_STREAM = 500_000                                    # 201-233, 235-258
B_MAIN_STREAM = 1 << 20        # phase 6's 1e7 points: 9 blocks and a tail
STREAM_ROWS = {}               # kernel row -> extra keys of its JSON row


def main_data(dev, seed, n):
    """Phase 6's data: 3 Gaussians at N(0, 16) centres, precision 2."""
    kg = torch.Generator(device=dev).manual_seed(seed)
    mu = torch.randn((3, D_MAIN), generator=kg, device=dev) * 4.0
    lm = torch.eye(D_MAIN, device=dev).expand(3, D_MAIN, D_MAIN) * 2.0
    return BayesianGMM.generate(kg, GaussParams(mu, lm), [.3, .4, .3], n)[0]


def states_close(tag, got, want, vg, vw, what='the in-memory fit'):
    """A streamed fit against `what` from the same state by phase 3's
    rule: traces within rtol 1e-5 (B1's lse), every state leaf within
    rtol 1e-4 of its largest magnitude (B1's statistics)."""
    ok_v, e_v = allclose_report(vg, vw, 1e-5, 0.0)
    worst = 0.0
    for a, b in zip(leaves(got), leaves(want)):
        if a.is_floating_point():
            scale = float(b.double().abs().max()) or 1.0
            worst = max(worst, float((a.double() - b.double()).abs().max())
                        / scale)
    print(f'{tag} vs {what} from the same state: trace max|err| '
          f'{e_v:.6g} (rtol 1e-5) {"ok" if ok_v else "FAIL"}; state leaves '
          f'max|err| / largest magnitude {worst:.3g} (<= 1e-4)')
    check(ok_v and worst <= 1e-4, f'{tag}: off {what}')


def stream_svi_cell(model, ds, card):
    """Cell (a), bench.py:201-233: fit_svi_stream from the file's
    minibatches, B=65536, 100 steps, step 0.5, group 16, float32 and bf16
    on the wire; prefetch depth 1 and 3 give bitwise equal states."""
    tag = (f'SVI-stream N={ds.shape[0]} B={B_SVI_STREAM} '
           f'{STEPS_SVI_STREAM} steps')

    def run(seed_np, **kw):
        batches = ds.minibatches(np.random.default_rng(seed_np),
                                 B_SVI_STREAM, STEPS_SVI_STREAM + 1)
        return model.fit_svi_stream(
            lambda i: next(batches), total_size=ds.shape[0], key=6,
            maxiter=STEPS_SVI_STREAM, step_size=0.5,
            batch_size=B_SVI_STREAM, group=16, **kw)

    for label, kw in (('f32', {}), ('bf16', dict(
            transfer_dtype=torch.bfloat16))):
        st, _, t_first = nested_fit(f'{tag} {label}',
                                    lambda: run(0, **kw), {})
        check(all_finite(st), f'{tag} {label}: state not finite')
        dt = min(seconds(lambda: run(rep, **kw), 1) for rep in (1, 2))
        print(f'rates on {card}, {tag} {label} on the wire: '
              f'{STEPS_SVI_STREAM * B_SVI_STREAM / dt / 1e6:.6g} M pts/s '
              f'ingested, {STEPS_SVI_STREAM / dt:.6g} steps/s (best of 2 '
              f'warm runs; first run {t_first:.6g} s)')
    a, b = run(0, prefetch=1), run(0, prefetch=3)
    same = all(torch.equal(u, v) for u, v in zip(leaves(a), leaves(b)))
    print(f'{tag}: prefetch depth 1 and 3 on the same batches bitwise '
          f'equal {same}')
    check(same, f'{tag}: the state depends on the prefetch depth')


def stream_vi_cell(model, ds, x, card):
    """Cell (b), bench.py:235-258: fit_vi_stream_full over the file in
    blocks of 5e5 (4 blocks), key 7 for 2 sweeps, then 10 sweeps from that
    state, against fit_vi_fused in memory over the same points."""
    nb = ds.shape[0] // B_VI_STREAM
    tag = f'VI-stream-full N={ds.shape[0]} B={B_VI_STREAM} ({nb} blocks)'

    def rbk(i):
        return ds.read_block(i * B_VI_STREAM, B_VI_STREAM)

    (st0, _), _, _ = nested_fit(
        f'{tag} key 7, 2 sweeps',
        lambda: model.fit_vi_stream_full(rbk, nb, key=7, maxiter=2),
        {'B1': 2 * nb})
    (st, v), _, _ = nested_fit(
        f'{tag} 10 sweeps', lambda: model.fit_vi_stream_full(
            rbk, nb, init_state=st0, maxiter=10), {'B1': 10 * nb})
    xs = x[:ds.shape[0]]
    st_m, v_m = model.fit_vi_fused(xs, maxiter=10, init_state=st0,
                                   randomize=False)
    states_close(tag, st, st_m, v, v_m)
    t_s = seconds(lambda: model.fit_vi_stream_full(rbk, nb, init_state=st0,
                                                   maxiter=10), 2)
    t_m = seconds(lambda: model.fit_vi_fused(xs, maxiter=10, init_state=st0,
                                             randomize=False), 2)
    print(f'rates on {card}, {tag}: streamed {10 / t_s:.6g} sweeps/s '
          f'({10 * ds.shape[0] / t_s / 1e6:.6g} M pts/s), in memory '
          f'{10 / t_m:.6g} sweeps/s (median of 2)')


def stream_main_cell(dev, model, x, path, card, errs, launches, ms):
    """Cell (c): phase 6's 1e7 points streamed from disk in blocks of
    2^20 (9 full blocks and a ragged tail) from phase 6's VI state:
    fit_vi_stream_full 5 against fit_vi_fused 5 in memory, MAP 5, ML-EM 5
    from the anchors of block 0, the bf16 leg, peak device memory, and
    B1 at the staged block beside its plain version."""
    n = x.shape[0]
    write_bin(path, x.cpu().numpy())
    ds = MmapDataset(path)
    nb = -(-n // B_MAIN_STREAM)
    tail = n - (nb - 1) * B_MAIN_STREAM
    tag = (f'stream N={n} K={K_MAIN} d={D_MAIN} B={B_MAIN_STREAM} ({nb - 1} '
           f'blocks and a {tail}-point tail)')

    def rbm(i):
        return ds.read_block(i * B_MAIN_STREAM, B_MAIN_STREAM)

    try:
        st, _ = model.fit_vi_fused(x, key=1, maxiter=20)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        (st_s, v_s), _, t_s = nested_fit(
            f'{tag} fit_vi_stream_full 5', lambda: model.fit_vi_stream_full(
                rbm, nb, init_state=st, maxiter=5), {'B1': 5 * nb})
        peak_s = torch.cuda.max_memory_allocated() - base
        launches['B1-stream'] = 5 * nb
        torch.cuda.reset_peak_memory_stats()
        st_m, v_m = model.fit_vi_fused(x, maxiter=5, init_state=st,
                                       randomize=False)
        torch.cuda.synchronize()
        peak_m = torch.cuda.max_memory_allocated() - base
        states_close(f'{tag} VI', st_s, st_m, v_s, v_m)
        (mst, mll), _, _ = nested_fit(
            f'{tag} fit_map_stream_full 5', lambda: model.fit_map_stream_full(
                rbm, nb, init_state=st, maxiter=5), {'B1': 5 * nb})
        elbo_report(f'{tag} MAP', mll, 'loglik')
        (est, ell), _, _ = nested_fit(
            f'{tag} fit_em_stream_full 5 (anchors from block 0)',
            lambda: model.fit_em_stream_full(rbm, nb, key=3, maxiter=5),
            {'B1': 5 * nb})
        elbo_report(f'{tag} ML-EM', ell, 'loglik')
        check(all_finite(mst) and all_finite(est),
              f'{tag}: MAP or ML-EM state not finite')
        # the staged ML-EM start, 3 times, against the same start formed
        # block by block without the stager: a buffer written on the copy
        # stream before work queued on the compute stream let go of it
        # gave a different start on most runs
        ref = unstaged_em_start(model, rbm, nb, 3, dev)
        worst = [relative_leaves(model.fit_em_stream_full(
            rbm, nb, key=3, maxiter=0)[0].params, ref) for _ in range(3)]
        print(f'{tag} ML-EM start, staged 3 times vs unstaged: worst leaf '
              f'{[float(f"{w:.3g}") for w in worst]} of its largest '
              f'magnitude (<= 1e-3)')
        check(max(worst) <= 1e-3, f'{tag}: the staged ML-EM start varies')
        (st_b, v_b), _, _ = nested_fit(
            f'{tag} fit_vi_stream_full 5, bf16 on the wire',
            lambda: model.fit_vi_stream_full(
                rbm, nb, init_state=st, maxiter=5,
                transfer_dtype=torch.bfloat16), {'B1': 5 * nb})
        gap = float(((v_b.double() - v_s.double()).abs()
                     / v_s.double().abs()).max())
        print(f'{tag} bf16 on the wire: ELBO {float(v_b[-1]):.9g} vs f32 '
              f'{float(v_s[-1]):.9g}, worst relative gap {gap:.3g} '
              f'(<= 1e-4)')
        check(all_finite(st_b) and gap <= 1e-4, f'{tag}: bf16 leg off')
        print(f'{tag}: peak device memory above the resident data: '
              f'streamed VI {peak_s / 2**20:.6g} MiB, in-memory VI '
              f'{peak_m / 2**20:.6g} MiB')
        check(peak_s < peak_m, f'{tag}: the stream takes more device memory')
        t_s = seconds(lambda: model.fit_vi_stream_full(
            rbm, nb, init_state=st, maxiter=5), 3)
        t_b = seconds(lambda: model.fit_vi_stream_full(
            rbm, nb, init_state=st, maxiter=5,
            transfer_dtype=torch.bfloat16), 3)
        t_m = seconds(lambda: model.fit_vi_fused(
            x, maxiter=5, init_state=st, randomize=False), 3)
        print(f'rates on {card}, {tag}: streamed VI {5 / t_s:.6g} sweeps/s '
              f'({1e3 * t_s / 5:.6g} ms a sweep), bf16 on the wire '
              f'{5 / t_b:.6g}, in memory {5 / t_m:.6g} (median of 3)')
    finally:
        ds.close()

    # B1 at the staged layout: one (2, 2^20) float32 buffer, read at the
    # full block and at the tail's runtime n
    spec = model._estep_spec()
    th, _ = pad_theta(spec.theta(st_s.components),
                      st_s.gating.expected_log_pi(), torch.float32)
    buf = kernel_xts((x[:B_MAIN_STREAM],))[0]
    acc, lse = cuda_estep.estep(buf, th, B_MAIN_STREAM)
    pacc, plse = cuda_estep.estep_plain(buf, th, B_MAIN_STREAM)
    atol = 1e-3 * B_MAIN_STREAM / 1e6
    ok_s, errs['B1-stream'] = allclose_report(acc, pacc, 1e-4, atol)
    ok_l, e_l = allclose_report(lse, plse, 1e-5, 0.0)
    t_acc, t_lse = cuda_estep.estep(buf, th, tail)
    p_acc, p_lse = cuda_estep.estep_plain(buf, th, tail)
    ok_t = (allclose_report(t_acc, p_acc, 1e-4, atol)[0]
            and allclose_report(t_lse, p_lse, 1e-5, 0.0)[0])
    print(f'B1-stream at the staged block ({B_MAIN_STREAM} points) vs plain: '
          f'stats max|err| {errs["B1-stream"]:.6g} (rtol 1e-4, atol '
          f'{atol:.3g}) {"ok" if ok_s else "FAIL"}, lse |err| {e_l:.6g} '
          f'(rtol 1e-5) {"ok" if ok_l else "FAIL"}; at the tail\'s n={tail} '
          f'{"ok" if ok_t else "FAIL"}')
    check(ok_s and ok_l and ok_t, 'B1-stream disagrees')
    m = cuda_estep.feature_width(cuda_estep.GAUSS, D_MAIN)
    ms['B1-stream'] = (cuda_ms(lambda: cuda_estep.estep(buf, th,
                                                        B_MAIN_STREAM), 20),
                       cuda_ms(lambda: cuda_estep.estep_plain(
                           buf, th, B_MAIN_STREAM), 3))
    tail_ms = cuda_ms(lambda: cuda_estep.estep(buf, th, tail), 20)
    WORK['B1-stream'] = estep_work(B_MAIN_STREAM, K_MAIN, m, D_MAIN)
    STREAM_ROWS['B1-stream'] = {'launches_per_sweep': nb,
                                'block': B_MAIN_STREAM, 'tail': tail,
                                'tail_ms': tail_ms}
    print(f'B1-stream time on {card}: kernel {ms["B1-stream"][0]:.6g} ms at '
          f'{B_MAIN_STREAM} points, {tail_ms:.6g} ms at the {tail}-point '
          f'tail, plain PyTorch {ms["B1-stream"][1]:.6g} ms; {nb} launches '
          f'a sweep')


def unstaged_em_start(model, read_block, n_blocks, key, dev):
    """fit_em_stream_full's start (anchors and their scale from block 0,
    statistics of every block) with each block moved to the card by a
    plain copy: the ML params."""
    from mimo_tpu_torch.models import mixture as tmix
    gen = torch.Generator(device=dev).manual_seed(key)
    x0 = torch.from_numpy(read_block(0)).to(dev)
    anchors = x0[tmix._anchor_indices(gen, x0.shape[0], model.size, dev)]
    scale2 = tmix.anchor_scale(x0)
    stats = None
    for i in range(n_blocks):
        b = torch.from_numpy(read_block(i)).to(dev)
        st = model.family.suff_stats((b,), tmix.anchor_resp(b, anchors,
                                                            scale2))
        stats = st if stats is None else tree_map2(torch.add, stats, st)
    return model.family.ml_update(stats)


def stream_paths(dev, seed, card, n_main, errs, launches, ms):
    """Phase 20: the out-of-core engines from files in the temp directory
    (deleted at the end) through the native loader, the reader thread and
    the pinned, double-buffered copies, B1 a block at a time."""
    x = main_data(dev, seed, n_main)
    model = BayesianGMM.make(size=K_MAIN, dim=D_MAIN, gating='dp', alpha=1.0,
                             kappa=0.05, psi_scale=0.5, device=dev)
    tmp = tempfile.gettempdir()
    paths = [os.path.join(tmp, f'chip_smoke_{name}_{os.getpid()}.bin')
             for name in ('2e6', 'main')]
    try:
        write_bin(paths[0], x[:N_STREAM].cpu().numpy())
        ds = MmapDataset(paths[0])
        print(f'stream: {paths[0]} {ds.shape} through the {ds.backend} '
              f'loader')
        check(ds.backend == 'native', 'the native loader did not build')
        try:
            stream_svi_cell(model, ds, card)
            stream_vi_cell(model, ds, x, card)
        finally:
            ds.close()
        stream_main_cell(dev, model, x, paths[1], card, errs, launches, ms)
    finally:
        for p in paths:
            if os.path.exists(p):
                os.unlink(p)
    del x, model
    torch.cuda.empty_cache()



# -- 21. mesh -----------------------------------------------------------------

N_MESH_SERVE = 1_000_003       # a count that 4 does not divide
N_MESH_SMALL = 1_000_000       # the chains and two-process legs
MESH_ROWS = {}                 # kernel row -> extra keys of its JSON row


def mesh_fit(tag, fit, want, sweeps, kind='sweep'):
    """nested_fit over a mesh: exactly the `want` launches, and exactly
    `sweeps` reductions of `kind`, none of them an all_reduce (one
    process). Returns (result, the launch counts read, seconds)."""
    from mimo_tpu_torch.parallel import mesh as pmesh
    pmesh.reset_counters()
    out, path, secs = nested_fit(tag, fit, want)
    c = pmesh.counters[kind]
    print(f'{tag}: {c["calls"]} reductions of {c["floats"]} floats, '
          f'{c["all_reduce"]} all_reduce')
    check(c['calls'] == sweeps and c['all_reduce'] == 0,
          f'{tag}: {c["calls"]} reductions, want {sweeps}')
    return out, path, secs


def relative_leaves(got, want):
    """The largest |got - want| of each floating leaf over that leaf's
    largest magnitude, worst over the leaves."""
    worst = 0.0
    for a, b in zip(leaves(got), leaves(want)):
        if a.is_floating_point():
            scale = float(b.double().abs().max()) or 1.0
            worst = max(worst, float((a.double() - b.double()).abs().max())
                        / scale)
    return worst


# phase 22's leg (e) in the two-process launch: each process streams its
# own file shard (parallel.launch.stream_run: 250,000 rows a position) and
# runs the dense engines on its shards; (name, engine, kwargs, sweeps)
STREAM_LEGS = [
    ('svi-stream', 'fit_svi_stream', dict(key=5, maxiter=32, step_size=0.5,
                                          rows=16384, group=16), 32),
    ('vi-stream', 'fit_vi_stream_full', dict(key=8, maxiter=3, n_blocks=4),
     3),
    ('vi-dense', 'fit_vi', dict(key=1, maxiter=5), 5),
    ('gibbs-dense', 'fit_gibbs', dict(key=2, maxiter=3, track_loglik=True),
     3)]


def mesh_leg_config(x_np):
    """parallel.launch.run_engines' config of the two-process leg: VI,
    Gibbs and MAP-EM at N=1e6 and, for the payload, VI at N=5e5, on two
    positions of this card a process, and phase 22's leg (e),
    STREAM_LEGS; then 50 lone all_reduce calls, each after a barrier
    (the transfer without the wait)."""
    runs = [('vi1', 'fit_vi_fused', dict(key=1, maxiter=1)),
            ('vi', 'fit_vi_fused', dict(key=1, maxiter=10)),
            ('gibbs1', 'fit_gibbs_fused', dict(key=2, maxiter=1)),
            ('gibbs', 'fit_gibbs_fused', dict(key=2, maxiter=10)),
            ('map', 'fit_map_fused', dict(key=1, maxiter=10)),
            ('vi-half', 'fit_vi_fused', dict(key=1, maxiter=3,
                                              n=N_MESH_SMALL // 2))]
    runs += [(name, engine, kw) for name, engine, kw, _ in STREAM_LEGS]
    return dict(x=x_np, dtype='float32', devices=['cuda:0'] * 2,
                model=dict(size=K_MAIN, dim=D_MAIN, gating='dp', alpha=1.0,
                           kappa=0.05, psi_scale=0.5), runs=runs, probe=50)


def mesh_two_process_checks(tag, ranks, ref):
    """The two ranks against the one-process run: VI's first sweep within
    f32 fold-order tolerance (every state leaf within 1e-5 of its largest
    magnitude, the ELBO within rtol 1e-6), the first Gibbs sweep's labels
    equal on every shard, the VI and MAP traces by phase 3's rule (rtol
    1e-5), and on each rank exactly one all_reduce of K m8 + 1 floats a
    sweep at N=1e6 and at N=5e5. Returns gloo's host seconds a call, as
    (inside a sweep, lone): inside a sweep the call also waits for this
    rank's kernels and for the other rank (the two share the card); a
    lone call follows a barrier with the card idle, and is the transfer
    alone (the median of the probe's calls)."""
    k, m8 = K_MAIN, 8
    per_sweep = []
    for r in ranks:
        vi1, ref1 = r['vi1']['out'], ref['vi1']['out']
        worst = max(relative_leaves(torch.as_tensor(a), torch.as_tensor(b))
                    for a, b in zip(leaves_np(vi1[0]), leaves_np(ref1[0])))
        e1 = float(abs(vi1[1][0] - ref1[1][0]) / abs(ref1[1][0]))
        mine = dict(zip(r['gibbs1']['out'].labels.positions,
                        r['gibbs1']['out'].labels.shards))
        same = all(np.array_equal(mine[p], lab) for p, lab in zip(
            ref['gibbs1']['out'].labels.positions,
            ref['gibbs1']['out'].labels.shards) if p in mine)
        tr = {name: float(np.max(np.abs(r[name]['out'][1]
                                        - ref[name]['out'][1])
                                 / np.abs(ref[name]['out'][1])))
              for name in ('vi', 'map')}
        counts = {name: r[name]['counters']['sweep']
                  for name in ('vi', 'gibbs', 'map', 'vi-half')}
        sweeps = {'vi': 10, 'gibbs': 10, 'map': 10, 'vi-half': 3}
        ok_c = all(c['calls'] == c['all_reduce'] == sweeps[name]
                   and c['floats'] == sweeps[name] * (k * m8 + 1)
                   for name, c in counts.items())
        secs = sum(c['seconds'] for c in counts.values())
        n_ar = sum(c['all_reduce'] for c in counts.values())
        lone = statistics.median(r['probe_seconds'])
        per_sweep.append((secs / n_ar, lone))
        print(f'{tag} rank {r["rank"]} of {r["world"]} (positions '
              f'{list(r["positions"])}): VI first sweep state leaves '
              f'{worst:.3g} of their largest magnitude (<= 1e-5), ELBO '
              f'{e1:.3g} (<= 1e-6); first Gibbs sweep labels equal {same}; '
              f'VI 10 trace {tr["vi"]:.3g}, MAP 10 {tr["map"]:.3g} (rtol '
              f'1e-5); all_reduce a sweep '
              f'{ {n: c["all_reduce"] / sweeps[n] for n, c in counts.items()} }'
              f' of {counts["vi"]["floats"] // 10} floats at N=1e6 and '
              f'{counts["vi-half"]["floats"] // 3} at N=5e5 (K m8 + 1 = '
              f'{k * m8 + 1}) {"ok" if ok_c else "FAIL"}; gloo all_reduce '
              f'{1e3 * per_sweep[-1][0]:.6g} ms a call inside a sweep (host '
              f'clock; with the wait for its own kernels and the other '
              f'rank), {1e3 * lone:.6g} ms a lone call (median of '
              f'{len(r["probe_seconds"])}, after a barrier, the card idle)')
        check(worst <= 1e-5 and e1 <= 1e-6 and same and ok_c
              and max(tr.values()) <= 1e-5,
              f'{tag}: rank {r["rank"]} off the one-process run')
    return tuple(statistics.mean(t) for t in zip(*per_sweep))


def mesh_two_process_stream_checks(tag, ranks, ref):
    """Phase 22's leg (e): each rank's streamed and dense runs against the
    one-process run: the SVI-stream state and the streamed and dense VI
    states within 1e-4 of their largest magnitude and their traces within
    rtol 1e-5 (phase 3's rule: only the fold order differs); the
    SVI-stream gating's stick counts within 1e-4 of their largest (its
    raw leaves are printed: lightly weighted components carry the fold
    order's rounding through the steps, see svi_close); the dense Gibbs
    loglik within rtol 1e-5 and its labels equal on at least 0.9999 of
    each rank's points (params drawn from statistics folded in another
    order flip rare near-ties); one all_reduce a sweep or step."""
    for r in ranks:
        errs_r, ok = {}, True
        for name, _, _, sweeps in STREAM_LEGS:
            got, want = r[name]['out'], ref[name]['out']
            c = r[name]['counters']['sweep']
            ok = ok and c['calls'] == c['all_reduce'] == sweeps
            if name == 'svi-stream':
                got, want = (got, None), (want, None)
                w = [np.asarray(s_.gating.gamma) for s_ in (got[0], want[0])]
                errs_r['svi-stream gamma'] = float(
                    np.max(np.abs(w[0] - w[1])) / np.max(np.abs(w[1])))
                ok = ok and errs_r['svi-stream gamma'] <= 1e-4
            if name == 'gibbs-dense':
                mine = dict(zip(got[0].labels.positions,
                                got[0].labels.shards))
                same = [np.mean(mine[p] == lab) for p, lab in zip(
                    want[0].labels.positions, want[0].labels.shards)
                    if p in mine]
                errs_r['labels equal'] = min(same)
                ok = ok and min(same) >= 0.9999
                got, want = (got[0][:4], got[1]), (want[0][:4], want[1])
            worst = max(relative_leaves(torch.as_tensor(a), torch.as_tensor(b))
                        for a, b in zip(leaves_np(got[0]), leaves_np(want[0])))
            errs_r[name] = worst
            if name in ('gibbs-dense', 'svi-stream'):
                worst = 0.0         # not held: see the docstring
            ok = ok and worst <= 1e-4
            if got[1] is not None:
                tr = float(np.max(np.abs(got[1] - want[1])
                                  / np.abs(want[1])))
                errs_r[f'{name} trace'] = tr
                ok = ok and tr <= 1e-5
        print(f'{tag} rank {r["rank"]} of {r["world"]}, each process '
              f'streaming its own file shard: '
              f'{ {k: float(f"{v:.3g}") for k, v in errs_r.items()} } (state '
              f'leaves <= 1e-4 of their largest magnitude, traces rtol 1e-5, '
              f'Gibbs labels >= 0.9999 equal); one all_reduce a sweep or '
              f'step {"ok" if ok else "FAIL"}')
        check(ok, f'{tag}: rank {r["rank"]} stream or dense leg off the '
              'one-process run')


def leaves_np(tree):
    if isinstance(tree, np.ndarray):
        return [tree]
    return [leaf for t in tree for leaf in leaves_np(t)]


def mesh_nccl_sweep(tag, dev, x):
    """A world-size-1 NCCL group in this process: one sharded VI sweep
    whose reduction is one NCCL all_reduce, equal to the sweep without a
    group; the group is destroyed on the way out."""
    import torch.distributed as dist
    from mimo_tpu_torch.parallel import init_distributed, make_mesh
    from mimo_tpu_torch.parallel import mesh as pmesh
    from mimo_tpu_torch.parallel.launch import free_port
    if not dist.is_nccl_available():
        print(f'{tag}: NCCL is not available in this torch build: skipped')
        return
    model = BayesianGMM.make(size=K_MAIN, dim=D_MAIN, gating='dp', alpha=1.0,
                             kappa=0.05, psi_scale=0.5, device=dev)
    want = model.fit_vi_fused(x, key=1, maxiter=1,
                              mesh=make_mesh(devices=[dev] * 2))
    init_distributed(f'localhost:{free_port()}', 1, 0, backend='nccl',
                     timeout=120.0)
    try:
        mesh = make_mesh(devices=[dev] * 2)
        pmesh.reset_counters()
        got = model.fit_vi_fused(x, key=1, maxiter=1, mesh=mesh)
        torch.cuda.synchronize()
        c = dict(pmesh.counters['sweep'])
    finally:
        dist.destroy_process_group()
    same = all(torch.equal(a, b) for a, b in zip(leaves(got), leaves(want)))
    print(f'{tag}: backend {"nccl"}, 1 sweep, {c["all_reduce"]} all_reduce '
          f'of {c["bytes"]} bytes in {1e3 * c["seconds"]:.6g} ms (host); '
          f'equal to the sweep without a group: {same}')
    check(c['all_reduce'] == 1 and same, f'{tag}: NCCL sweep off')


def mesh_serving(tag, dev, gen, mesh, card, errs, launches, ms):
    """B4, B5 (p=1) and B6 (p=3, MNW) on random posteriors over the
    N=1,000,003 points sharded on `mesh`: one launch a shard, each
    shard's rows bitwise the unsharded launch's (else within phase 16's
    tolerances); each sharded row timed at its first shard."""
    from mimo_tpu_torch.parallel import shard_data
    n = N_MESH_SERVE
    post = random_ng_posterior(gen, K_MAIN, D_MAIN, dev)
    log_w = torch.log_softmax(torch.randn((K_MAIN,), generator=gen,
                                          device=dev), 0)
    x = torch.randn((n, D_MAIN), generator=gen, device=dev) * 4.0
    xs = shard_data(mesh, x)
    reset_counts()
    outs = cuda_diag_predict.diag_predictive_cuda_sharded(post, log_w,
                                                          xs.shards)
    torch.cuda.synchronize()
    launches['B4-sharded'] = read_counts()['B4']
    whole = cuda_diag_predict.diag_predictive_cuda(post, log_w, x)
    got = torch.cat(outs)
    same4 = torch.equal(got, whole)
    rows, aux = cuda_diag_predict.diag_predict_coefficients(post, log_w)
    xt0 = xs.shards[0].T.contiguous()
    n0 = xt0.shape[1]
    errs['B4-sharded'] = float((outs[0].double() - cuda_diag_predict
                                .diag_predict_plain(xt0, rows, aux, n0)
                                .double()).abs().max())
    ms['B4-sharded'] = (
        cuda_ms(lambda: cuda_diag_predict.diag_predict(xt0, rows, aux, n0),
                20),
        cuda_ms(lambda: cuda_diag_predict.diag_predict_plain(xt0, rows, aux,
                                                             n0), 3))
    WORK['B4-sharded'] = b4_work(n0, D_MAIN, aux)
    LIBRARY['B4-sharded'] = cuda_ms(library_mixture(post, log_w,
                                                    xs.shards[0]), 3)
    print(f'{tag} B4 over {len(xs.shards)} shards of N={n}: launches '
          f'{launches["B4-sharded"]}, bitwise the unsharded launch {same4} '
          f'(max|diff| {float((got - whole).abs().max()):.3g}); shard 0 vs '
          f'plain max|err| {errs["B4-sharded"]:.3g}')
    check(launches['B4-sharded'] == len(xs.shards)
          and (same4 or allclose_report(got, whole, 1e-5, 1e-4)[0]),
          f'{tag}: sharded B4 off the unsharded launch')
    for name, d, p in (('B5-sharded', 1, 1), ('B6-sharded', 2, 3)):
        basis, experts = random_ilr_posterior(gen, K_MAIN, d, p, dev)
        xx, yy = regression_data(gen, n, d, p, dev)
        xsh, ysh = shard_data(mesh, xx, yy)
        if p == 1:
            serve = cuda_ilr_predict.ilr_predict_cuda_sharded
            th, aux_i = cuda_ilr_predict.ilr_predict_coefficients(
                basis, experts, log_w)
            vc = None
        else:
            serve = cuda_ilr_predict.ilr_p_predict_cuda_sharded
            th, aux_i, vc = cuda_ilr_predict.ilr_p_predict_coefficients(
                basis, experts, log_w, True, True)
        reset_counts()
        outs = serve(basis, experts, log_w, list(xsh.shards),
                     list(ysh.shards))
        torch.cuda.synchronize()
        launches[name] = read_counts()['B5' if p == 1 else 'B6']
        whole = serve(basis, experts, log_w, [xx], [yy])[0]
        cat = [torch.cat([o[i] for o in outs]) for i in range(3)]
        same = all(torch.equal(a, b) for a, b in zip(cat, whole))
        # else phase 16's tolerances: mean, var, NLPD
        ok_w = all(allclose_report(a, b, rtol, atol)[0] for a, b, (rtol, atol)
                   in zip(cat, whole, ((1e-4, 1e-4), (2e-3, 1e-5),
                                       (1e-3, 2e-3))))
        xt0 = torch.cat([xsh.shards[0].T, ysh.shards[0].T]).contiguous()
        n0 = xt0.shape[1]
        if p == 1:
            kern = functools.partial(cuda_ilr_predict.ilr_predict, xt0, th,
                                     aux_i, n0, True, False)
            plain = functools.partial(cuda_ilr_predict.ilr_predict_plain,
                                      xt0, th, aux_i, n0, True, False)
        else:
            kern = functools.partial(cuda_ilr_predict.ilr_p_predict, xt0, th,
                                     aux_i, vc, n0, p, True, False)
            plain = functools.partial(cuda_ilr_predict.ilr_p_predict_plain,
                                      xt0, th, aux_i, vc, n0, p, True, False)
        ok_p, errs[name], _ = compare_serving(kern(), plain(), p, False)
        ms[name] = (cuda_ms(kern, 20), cuda_ms(plain, 3))
        WORK[name] = serving_work(n0, K_MAIN, d, p)
        print(f'{tag} {name[:2]} (d={d}, p={p}, MNW) over {len(outs)} shards '
              f'of N={n}: launches {launches[name]}, bitwise the unsharded '
              f'launch {same}; shard 0 vs plain max|err| {errs[name]:.3g} '
              f'{"ok" if ok_p else "FAIL"}')
        check(launches[name] == len(outs) and ok_w and ok_p,
              f'{tag}: sharded {name[:2]} off')


def mesh_paths(dev, seed, card, n_main, errs, launches, ms):
    """Phase 21: the device mesh (parallel/mesh.py) in one process over
    four positions on this card, against the unsharded engines from the
    same keys; empty shards; fit_chains over a (2, 2) mesh; two
    processes through gloo; a world-size-1 NCCL sweep."""
    from mimo_tpu_torch.ops.philox import shard_seed
    from mimo_tpu_torch.parallel import make_mesh, shard_data
    from mimo_tpu_torch.parallel import mesh as pmesh
    from mimo_tpu_torch.bridge import state_to_numpy
    from mimo_tpu_torch.parallel.launch import launch, run_engines
    x = main_data(dev, seed, n_main)
    # the two worker processes run first and alone, this process idle,
    # so that their all_reduce times see no other work on the card
    cfg = mesh_leg_config(x[:N_MESH_SMALL].cpu().numpy())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ranks = launch(run_engines, 2, (cfg,), backend='gloo', timeout=400.0)
    print(f'two processes through gloo on {card}: '
          f'{time.perf_counter() - t0:.6g} s for the launch (spawn, CUDA '
          f'init, the runs), alone on the card')
    ref = state_to_numpy(run_engines(dict(cfg, devices=cfg['devices'] * 2)))
    gloo_s = mesh_two_process_checks(
        f'mesh (1, 4) over 2 processes x 2 positions, N={N_MESH_SMALL}',
        ranks, ref)
    mesh_two_process_stream_checks(
        f'mesh (1, 4) over 2 processes x 2 positions, N={N_MESH_SMALL}',
        ranks, ref)
    del ranks, ref

    model = BayesianGMM.make(size=K_MAIN, dim=D_MAIN, gating='dp', alpha=1.0,
                             kappa=0.05, psi_scale=0.5, device=dev)
    spec = model._estep_spec()
    mesh = make_mesh(devices=[dev] * 4)
    xs = shard_data(mesh, x)
    nd = len(xs.shards)
    tag = f'mesh (1, {nd}) on {dev} N={n_main} K={K_MAIN} d={D_MAIN}'
    st_u, v_u = model.fit_vi_fused(x, key=1, maxiter=20)
    (st_s, v_s), path_vi, _ = mesh_fit(
        f'{tag} fit_vi_fused 20',
        lambda: model.fit_vi_fused(xs, key=1, maxiter=20, mesh=mesh),
        {'B1': nd * 20}, 20)
    launches['B1-sharded'] = path_vi['B1']
    tr_vi = float(((v_s.double() - v_u.double()).abs()
                   / v_u.double().abs()).max())
    print(f'{tag} VI 20 vs unsharded from the same key: trace max rel '
          f'{tr_vi:.3g} (rtol 1e-5); state leaves '
          f'{relative_leaves(st_s, st_u):.3g} of their largest magnitude '
          f'(not held: from the random start, components that share a '
          f'cluster trade mass on f32 rounding while the ELBO stays put)')
    check(tr_vi <= 1e-5, f'{tag}: sharded VI trace off')
    # 5 sweeps from the unsharded fit's state, as phase 20 holds the
    # streamed sweep: trace and every state leaf by phase 3's rule
    st_5, v_5 = model.fit_vi_fused(xs, maxiter=5, init_state=st_u,
                                   randomize=False, mesh=mesh)
    st_5u, v_5u = model.fit_vi_fused(x, maxiter=5, init_state=st_u,
                                     randomize=False)
    states_close(f'{tag} VI 5 from the VI state', st_5, st_5u, v_5, v_5u)

    # one sweep from a shared state, B1 per shard vs one launch
    comps, log_pi = st_u.components, st_u.gating.expected_log_pi()
    xts = [kernel_xts((s,)) for s in xs.shards]
    one = cuda_estep.fused_estep_cuda(spec, comps, log_pi, kernel_xts((x,)),
                                      n_main)
    shd = cuda_estep.fused_estep_cuda_sharded(spec, comps, log_pi, xts, mesh)
    e_lse = float(abs(shd.lse.double() - one.lse.double())
                  / abs(one.lse.double()))
    e_st = relative_leaves(shd.stats, one.stats)
    print(f'{tag} one sweep from the VI state: lse rel {e_lse:.3g}, '
          f'statistics {e_st:.3g} of their largest magnitude (each <= 1e-5)')
    check(e_lse <= 1e-5 and e_st <= 1e-5, f'{tag}: sharded sweep off')

    # Gibbs: the first sweep's shard 0 against the unsharded sweep
    g_u = model.fit_gibbs_fused(x, key=2, maxiter=1)
    g_1, _, _ = mesh_fit(f'{tag} fit_gibbs_fused 1', lambda:
                         model.fit_gibbs_fused(xs, key=2, maxiter=1,
                                               mesh=mesh), {'B2': nd}, 1)
    n0 = xs.shards[0].shape[0]
    same0 = torch.equal(g_1.labels.shards[0], g_u.labels[:n0])
    print(f'{tag} Gibbs first sweep: shard 0 labels bitwise the unsharded '
          f'sweep\'s on its {n0} points {same0}')
    check(same0, f'{tag}: shard 0 labels differ from the unsharded sweep')
    g_s, path_g, _ = mesh_fit(f'{tag} fit_gibbs_fused 20', lambda:
                              model.fit_gibbs_fused(xs, key=2, maxiter=20,
                                                    mesh=mesh),
                              {'B2': nd * 20}, 20)
    launches['B2-sharded'] = path_g['B2']
    check(all_finite(g_s.components) and sum(
        lab.shape[0] for lab in g_s.labels.shards) == n_main,
        f'{tag}: sharded Gibbs state')
    # each shard's statistics are the one-hot sums of its own labels
    params = model.family.mode_params(g_s.components)
    lp_g = torch.log(torch.clamp(g_s.gating.mean(), min=1e-37))
    th_g, _ = pad_theta(spec.theta_plugin(params), lp_g, torch.float32)
    seed_t = torch.tensor(20261017, dtype=torch.int64, device=dev)
    worst_oh = 0.0
    for j, t in enumerate(xts):
        lab, acc = cuda_gibbs.gibbs(t[0], th_g, shard_seed(seed_t, j),
                                    t[0].shape[1])
        mag = float(acc.abs().max())
        worst_oh = max(worst_oh, gibbs_acc_err(t[0], t[0].shape[1],
                                               cuda_estep.GAUSS, 0, lab, acc)
                       / mag)
    errs['B2-sharded'] = worst_oh
    print(f'{tag} B2 per shard: statistics vs the one-hot sums of its own '
          f'labels, worst {worst_oh:.3g} of the largest entry (<= 1e-5)')
    check(worst_oh <= 1e-5, f'{tag}: B2 shard statistics off its labels')
    (st_m, v_m), path_map, _ = mesh_fit(
        f'{tag} fit_map_fused 20',
        lambda: model.fit_map_fused(xs, key=1, maxiter=20, mesh=mesh),
        {'B1': nd * 20}, 20)
    check(all_finite(st_m) and bool(torch.isfinite(v_m).all()),
          f'{tag}: sharded MAP-EM not finite')

    # B3: serving per shard, no reduction
    lp_u = model.log_predictive(st_u, x)
    pmesh.reset_counters()
    lp_s, path_lp, _ = nested_fit(f'{tag} log_predictive', lambda:
                                  model.log_predictive(st_u, xs, mesh=mesh),
                                  {'B3': nd})
    launches['B3-sharded'] = path_lp['B3']
    same3 = torch.equal(lp_s.gather(), lp_u)
    print(f'{tag} B3 over {nd} shards bitwise the unsharded launch {same3} '
          f'(max|diff| {float((lp_s.gather() - lp_u).abs().max()):.3g}); '
          f'reductions {pmesh.counters["sweep"]["calls"]}')
    check((same3 or allclose_report(lp_s.gather(), lp_u, 1e-5, 1e-4)[0])
          and pmesh.counters['sweep']['calls'] == 0,
          f'{tag}: sharded B3 off the unsharded launch')

    # empty shards: N=5 on eight positions
    mesh8 = make_mesh(devices=[dev] * 8)
    x5 = x[:5]
    x5s = shard_data(mesh8, x5)
    xts5 = [kernel_xts((s,)) for s in x5s.shards]
    reset_counts()
    e5 = cuda_estep.fused_estep_cuda_sharded(spec, comps, log_pi, xts5,
                                             mesh8)
    torch.cuda.synchronize()
    l5 = read_counts()['B1']
    w5 = cuda_estep.fused_estep_cuda(spec, comps, log_pi, kernel_xts((x5,)),
                                     5)
    ok5 = (l5 == 5 and relative_leaves(e5.stats, w5.stats) <= 1e-6
           and float(abs(e5.lse - w5.lse) / abs(w5.lse)) <= 1e-6)
    labs, g5 = cuda_gibbs.fused_gibbs_cuda_sharded(spec, seed_t, params,
                                                   lp_g, xts5, mesh8)
    ok5g = [t.shape[0] for t in labs] == [1] * 5 + [0] * 3
    for j in range(5):
        lab1, _ = cuda_gibbs.fused_gibbs_cuda(
            spec, shard_seed(seed_t, j), params, lp_g, xts5[j], 1)
        ok5g = ok5g and torch.equal(lab1, labs[j])
    ok5g = ok5g and float(g5.counts.sum()) == 5.0
    lp5 = model.log_predictive(st_u, x5s, mesh=mesh8)
    ok5p = torch.equal(lp5.gather(), model.log_predictive(st_u, x5))
    print(f'{tag} N=5 on 8 positions (3 empty): B1 {l5} launches, the '
          f'unsharded statistics and lse {"ok" if ok5 else "FAIL"}; B2 each '
          f'shard its one-point launch at its seed {"ok" if ok5g else "FAIL"}'
          f'; B3 bitwise the unsharded launch {ok5p}')
    check(ok5 and ok5g and ok5p, f'{tag}: empty shards off')

    # fit_chains over a (2, 2) mesh
    m22 = make_mesh(n_chain=2, devices=[dev] * 4)
    xc = x[:N_MESH_SMALL]
    keys = [11, 12, 13, 14]
    (c_s, cv_s), path_c, _ = mesh_fit(
        f'fit_chains VI 10 over a (2, 2) mesh, 4 keys, N={N_MESH_SMALL}',
        lambda: fit_chains(model, 'fit_vi_fused', shard_data(m22, xc), keys,
                           mesh=m22, maxiter=10), {'B1': 2 * 2 * 10}, 20)
    c_u, cv_u = fit_chains(model, 'fit_vi_fused', xc, keys, maxiter=10)
    tr_c = float(((cv_s.double() - cv_u.double()).abs()
                  / cv_u.double().abs()).max())
    print(f'fit_chains (2, 2) vs unsharded: traces max rel {tr_c:.3g} '
          f'(rtol 1e-5, as VI above); state leaves '
          f'{relative_leaves(c_s, c_u):.3g} of their largest magnitude '
          f'(not held, as VI above)')
    check(tr_c <= 1e-5 and all_finite(c_s), 'fit_chains over a mesh off')

    mesh_nccl_sweep('world-size-1 NCCL group', dev, x[:N_MESH_SMALL])

    # serving at N=1,000,003
    mesh_serving('mesh (1, 4)', dev, torch.Generator(device=dev).manual_seed(
        seed + 21), mesh, card, errs, launches, ms)

    # timings: a sweep sharded and unsharded, each shard's B1 / B2, the
    # fold
    t_vi_u = seconds(lambda: model.fit_vi_fused(
        x, maxiter=10, init_state=st_u, randomize=False), 3) / 10
    t_vi_s = seconds(lambda: model.fit_vi_fused(
        xs, maxiter=10, init_state=st_u, randomize=False, mesh=mesh), 3) / 10
    t_g_u = seconds(lambda: model.fit_gibbs_fused(x, key=3, maxiter=10),
                    3) / 10
    t_g_s = seconds(lambda: model.fit_gibbs_fused(xs, key=3, maxiter=10,
                                                  mesh=mesh), 3) / 10
    th_v, _ = pad_theta(spec.theta(comps), log_pi, torch.float32)
    per_b1 = [cuda_ms(lambda t=t: cuda_estep.estep(t[0], th_v,
                                                   t[0].shape[1]), 20)
              for t in xts]
    per_b2 = [cuda_ms(lambda t=t, j=j: cuda_gibbs.gibbs(
        t[0], th_g, shard_seed(seed_t, j), t[0].shape[1]), 20)
        for j, t in enumerate(xts)]
    one_b1 = cuda_ms(lambda: cuda_estep.estep(kernel_xts((x,))[0], th_v,
                                              n_main), 20)
    parts = [cuda_estep.estep_packed(t[0], th_v, t[0].shape[1]) for t in xts]
    zero = torch.zeros_like(parts[0])
    fold = cuda_ms(lambda: mesh.reduce(parts, zero.clone()), 50)
    print(f'mesh timings on {card}, N={n_main} over {nd} shards of '
          f'{n0}: VI sweep {1e3 * t_vi_s:.6g} ms sharded vs {1e3 * t_vi_u:.6g} '
          f'unsharded, Gibbs sweep {1e3 * t_g_s:.6g} vs {1e3 * t_g_u:.6g} '
          f'(host clock, median of 3 runs of 10); B1 per shard '
          f'{[round(t, 6) for t in per_b1]} ms (sum {sum(per_b1):.6g}) vs '
          f'one launch {one_b1:.6g}; B2 per shard '
          f'{[round(t, 6) for t in per_b2]} ms (sum {sum(per_b2):.6g}); '
          f'the fold of {nd} partials {fold:.6g} ms; gloo all_reduce '
          f'(two processes) {1e3 * gloo_s[0]:.6g} ms a call inside a sweep, '
          f'{1e3 * gloo_s[1]:.6g} ms a lone call')

    # the sharded kernel rows: one shard's launch, held to its plain
    # version, timed, with the bound of the shard's work
    m = cuda_estep.feature_width(cuda_estep.GAUSS, D_MAIN)
    xt0 = xts[0][0]
    acc, lse = cuda_estep.estep(xt0, th_v, n0)
    pacc, plse = cuda_estep.estep_plain(xt0, th_v, n0)
    ok_b1, errs['B1-sharded'] = allclose_report(acc, pacc, 1e-4,
                                                1e-3 * n0 / 1e6)
    check(ok_b1 and allclose_report(lse, plse, 1e-5, 0.0)[0],
          'B1 on a shard disagrees with its plain version')
    ms['B1-sharded'] = (per_b1[0], cuda_ms(
        lambda: cuda_estep.estep_plain(xt0, th_v, n0), 3))
    ms['B2-sharded'] = (per_b2[0], cuda_ms(
        lambda: cuda_gibbs.gibbs_plain(xt0, th_g, seed_t, n0), 3))
    thq, aux = cuda_predict.predictive_coefficients(
        comps, model.predictive_log_weights(st_u))
    xq = xs.shards[0].T.contiguous()
    errs['B3-sharded'] = float((cuda_predict.predict(xq, thq, aux, n0)
                                .double() - cuda_predict.predict_plain(
                                    xq, thq, aux, n0).double()).abs().max())
    ms['B3-sharded'] = (cuda_ms(lambda: cuda_predict.predict(xq, thq, aux,
                                                             n0), 20),
                        cuda_ms(lambda: cuda_predict.predict_plain(
                            xq, thq, aux, n0), 3))
    WORK['B1-sharded'] = estep_work(n0, K_MAIN, m, D_MAIN)
    WORK['B2-sharded'] = gibbs_work(xt0, th_g, n0, m)
    WORK['B3-sharded'] = density_work(n0, K_MAIN, quad_fmas(D_MAIN), D_MAIN,
                                      2, products=point_products(D_MAIN))
    # launches per path, as counted in each path's run above
    paths = {'B1-sharded': {'fit_vi_fused': path_vi['B1'],
                            'fit_map_fused': path_map['B1'],
                            'fit_chains (2, 2) VI': path_c['B1']},
             'B2-sharded': {'fit_gibbs_fused': path_g['B2']},
             'B3-sharded': {'log_predictive': path_lp['B3']},
             'B4-sharded': {'diag_predictive_cuda_sharded':
                            launches['B4-sharded']},
             'B5-sharded': {'ilr_predict_cuda_sharded':
                            launches['B5-sharded']},
             'B6-sharded': {'ilr_p_predict_cuda_sharded':
                            launches['B6-sharded']}}
    for name, per in paths.items():
        MESH_ROWS[name] = {'shards': nd, 'launches_per_path': per,
                           'shard_n': -(-N_MESH_SERVE // nd)}
    for name in ('B1-sharded', 'B2-sharded', 'B3-sharded'):
        MESH_ROWS[name]['shard_n'] = n0
    MESH_ROWS['B1-sharded'].update(per_shard_ms=per_b1, one_launch_ms=one_b1,
                                   fold_ms=fold, sweep_ms=1e3 * t_vi_s,
                                   unsharded_sweep_ms=1e3 * t_vi_u,
                                   gloo_all_reduce_ms=1e3 * gloo_s[0],
                                   gloo_lone_all_reduce_ms=1e3 * gloo_s[1])
    MESH_ROWS['B2-sharded'].update(per_shard_ms=per_b2,
                                   sweep_ms=1e3 * t_g_s,
                                   unsharded_sweep_ms=1e3 * t_g_u)
    for name in paths:
        print(f'{name} time on {card} at one shard: kernel '
              f'{ms[name][0]:.6g} ms, plain PyTorch {ms[name][1]:.6g} ms')
    del x, xs, model
    torch.cuda.empty_cache()


# -- 22. streams and dense engines over the mesh ------------------------------

N_SHARD_STREAM = B_MAIN_STREAM // 4    # one shard of a staged 2^20 block
N_SHARD_SVI = B_SVI_STREAM // 4        # one shard of a staged minibatch


def shard_row(name, view, th, n, card, errs, ms):
    """B1 on `view`, a column view of a staged float32 buffer at a shard's
    offset, against its plain version (phase 3's tolerances), timed."""
    acc, lse = cuda_estep.estep(view, th, n)
    pacc, plse = cuda_estep.estep_plain(view, th, n)
    ok, errs[name] = allclose_report(acc, pacc, 1e-4, 1e-3 * n / 1e6)
    ok_l, e_l = allclose_report(lse, plse, 1e-5, 0.0)
    ms[name] = (cuda_ms(lambda: cuda_estep.estep(view, th, n), 20),
                cuda_ms(lambda: cuda_estep.estep_plain(view, th, n), 3))
    WORK[name] = estep_work(n, K_MAIN, cuda_estep.feature_width(
        cuda_estep.GAUSS, D_MAIN), D_MAIN)
    dev_ms = profiled_device_ms(lambda: cuda_estep.estep(view, th, n))
    print(f'{name} at a shard of {n} points (column offset '
          f'{view.storage_offset()}) vs plain: stats max|err| '
          f'{errs[name]:.6g} (rtol 1e-4) {"ok" if ok else "FAIL"}, lse |err| '
          f'{e_l:.6g} (rtol 1e-5) {"ok" if ok_l else "FAIL"}; time on {card}: '
          f'kernel {ms[name][0]:.6g} ms a call by CUDA events (the host '
          f'issue of each call included), device {ms_text(dev_ms)} by the '
          f'profiler, plain PyTorch {ms[name][1]:.6g} ms')
    check(ok and ok_l, f'{name} disagrees with its plain version')
    return dev_ms


def mesh_stream_cell(dev, model, x, mesh, ds, card, errs, launches, ms):
    """Leg (a): phase 20's 1e7 points streamed from disk over a (1, 4)
    mesh on this card, from phase 6's VI state: VI 5 and MAP 5 against
    the unsharded streamed fits by phase 3's rule, ML-EM 5 from a given
    state (the anchor start refused over a mesh), bf16 on the wire, B1
    exactly 4 launches a block and one reduction a sweep, peak device
    memory beside the unsharded stream's; the B1-stream-sharded row."""
    n, nd = x.shape[0], len(mesh.positions)
    nb = -(-n // B_MAIN_STREAM)
    tail = n - (nb - 1) * B_MAIN_STREAM
    tag = (f'stream over a (1, {nd}) mesh N={n} K={K_MAIN} d={D_MAIN} '
           f'B={B_MAIN_STREAM} ({nb - 1} blocks and a {tail}-point tail)')

    def rbm(i):
        return ds.read_block(i * B_MAIN_STREAM, B_MAIN_STREAM)

    st, _ = model.fit_vi_fused(x, key=1, maxiter=20)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (st_s, v_s), path_s, _ = mesh_fit(
        f'{tag} fit_vi_stream_full 5', lambda: model.fit_vi_stream_full(
            rbm, nb, init_state=st, maxiter=5, mesh=mesh),
        {'B1': 5 * nb * nd}, 5)
    peak_s = torch.cuda.max_memory_allocated() - base
    launches['B1-stream-sharded'] = path_s['B1']
    torch.cuda.reset_peak_memory_stats()
    (st_u, v_u), _, _ = nested_fit(
        f'{tag} unsharded fit_vi_stream_full 5',
        lambda: model.fit_vi_stream_full(rbm, nb, init_state=st, maxiter=5),
        {'B1': 5 * nb})
    peak_u = torch.cuda.max_memory_allocated() - base
    states_close(f'{tag} VI', st_s, st_u, v_s, v_u,
                 'the unsharded streamed fit')
    for kind, init in (('map', st), ('em', model.fit_em_fused(
            x, key=3, maxiter=1)[0])):
        eng = getattr(model, f'fit_{kind}_stream_full')
        (a, ta), _, _ = mesh_fit(
            f'{tag} fit_{kind}_stream_full 5', lambda: eng(
                rbm, nb, init_state=init, maxiter=5, mesh=mesh),
            {'B1': 5 * nb * nd}, 5)
        b, tb = eng(rbm, nb, init_state=init, maxiter=5)
        if kind == 'map':
            states_close(f'{tag} MAP', a, b, ta, tb,
                         'the unsharded streamed fit')
            continue
        # ML-EM's precision is the inverse of E[x x'] - mu mu' formed from
        # float32 statistics, which cancels where |mu| is large against
        # sigma (ROADMAP C, the open [1; x; x^2] fault): a change of fold
        # order moves it more than the means, so it is printed, not held
        ok_v, e_v = allclose_report(ta, tb, 1e-5, 0.0)
        held = relative_leaves((a.params.mu, a.log_pi),
                               (b.params.mu, b.log_pi))
        prec = relative_leaves(a.params.lmbda, b.params.lmbda)
        print(f'{tag} ML-EM vs the unsharded streamed fit from the same '
              f'state: trace max|err| {e_v:.6g} (rtol 1e-5) '
              f'{"ok" if ok_v else "FAIL"}; means and log weights '
              f'{held:.3g} of their largest magnitude (<= 1e-4); '
              f'precisions {prec:.3g} (not held)')
        check(ok_v and held <= 1e-4 and all_finite(a),
              f'{tag}: ML-EM off the unsharded streamed fit')
    try:
        model.fit_em_stream_full(rbm, nb, key=3, maxiter=1, mesh=mesh)
        refused = False
    except NotImplementedError:
        refused = True
    print(f'{tag} ML-EM anchor start over the mesh refused, as the JAX '
          f'package refuses it: {refused}')
    check(refused, f'{tag}: the ML-EM anchor start ran over a mesh')
    (st_b, v_b), _, _ = mesh_fit(
        f'{tag} fit_vi_stream_full 5, bf16 on the wire',
        lambda: model.fit_vi_stream_full(rbm, nb, init_state=st, maxiter=5,
                                         transfer_dtype=torch.bfloat16,
                                         mesh=mesh), {'B1': 5 * nb * nd}, 5)
    gap = float(((v_b.double() - v_s.double()).abs()
                 / v_s.double().abs()).max())
    print(f'{tag} bf16 on the wire: worst relative gap to f32 {gap:.3g} '
          f'(<= 1e-4)')
    check(all_finite(st_b) and gap <= 1e-4, f'{tag}: bf16 leg off')
    print(f'{tag}: peak device memory above the resident data: sharded '
          f'{peak_s / 2**20:.6g} MiB, unsharded {peak_u / 2**20:.6g} MiB')
    check(peak_s <= peak_u + 2**20, f'{tag}: the sharded stream takes more '
          'device memory than the unsharded one')
    t_s = seconds(lambda: model.fit_vi_stream_full(
        rbm, nb, init_state=st, maxiter=5, mesh=mesh), 3)
    t_u = seconds(lambda: model.fit_vi_stream_full(
        rbm, nb, init_state=st, maxiter=5), 3)
    print(f'rates on {card}, {tag}: VI {1e3 * t_s / 5:.6g} ms a sweep over '
          f'the mesh, {1e3 * t_u / 5:.6g} unsharded (median of 3 runs of 5)')
    # one shard of the staged layout: shard 1 of the first block, a
    # column view at offset 262,144
    spec = model._estep_spec()
    th, _ = pad_theta(spec.theta(st_s.components),
                      st_s.gating.expected_log_pi(), torch.float32)
    buf = kernel_xts((x[:B_MAIN_STREAM],))[0]
    s = N_SHARD_STREAM
    dev_ms = shard_row('B1-stream-sharded', buf[:, s:2 * s], th, s, card,
                       errs, ms)
    STREAM_ROWS['B1-stream-sharded'] = {
        'device_ms': dev_ms,
        'launches_per_sweep': nb * nd, 'shards': nd, 'shard_n': s,
        'tail_shard_n': -(-tail // nd), 'sweep_ms': 1e3 * t_s / 5,
        'unsharded_sweep_ms': 1e3 * t_u / 5, 'peak_mib': peak_s / 2**20,
        'unsharded_peak_mib': peak_u / 2**20}


def svi_close(model, got, want, xs, lp_rtol=1e-5, w_atol=1e-4):
    """An SVI state against another of the same batches whose statistics
    were folded in another order, by what the fit predicts: the mean log
    predictive of the points xs within `lp_rtol` and the posterior-mean
    weights within `w_atol`. The raw leaves are printed, not held: a
    component that holds few points moves its scatter with 1/its count,
    so the fold order's rounding carried through the steps shows there
    (1.1e-3 of psi's largest magnitude after 100 steps on the CPU in
    float32, where the mean log predictive agreed to 1.1e-7). Returns
    (ok, the line's text)."""
    la = float(model.log_predictive(got, xs).double().mean())
    lb = float(model.log_predictive(want, xs).double().mean())
    e_lp = abs(la - lb) / abs(lb)
    e_w = float((got.gating.mean() - want.gating.mean()).abs().max())
    ok = e_lp <= lp_rtol and e_w <= w_atol
    return ok, (f'mean log predictive {la:.9g} vs {lb:.9g} (rel '
                f'{e_lp:.3g}, <= {lp_rtol:g}), weights max|diff| {e_w:.3g} '
                f'(<= {w_atol:g}), raw state leaves '
                f'{relative_leaves(got, want):.3g} of their largest magnitude '
                f'(not held) {"ok" if ok else "FAIL"}')


def mesh_svi_stream_cell(dev, model, x, mesh, ds, card, errs, launches, ms):
    """Leg (b): phase 20's 2e6-point file through fit_svi_stream over the
    (1, 4) mesh (B=65536, 100 steps, group 16), B1 exactly 4 launches
    and one reduction a step, against the same run over a one-position
    mesh, from the random start and from the VI state of the file's
    points; the B1-svi-stream-sharded row."""
    from mimo_tpu_torch.parallel import make_mesh
    nd = len(mesh.positions)
    tag = (f'SVI-stream over a (1, {nd}) mesh N={ds.shape[0]} '
           f'B={B_SVI_STREAM} {STEPS_SVI_STREAM} steps')

    def run(m, init=None):
        batches = ds.minibatches(np.random.default_rng(0), B_SVI_STREAM,
                                 STEPS_SVI_STREAM + 1)
        return model.fit_svi_stream(
            lambda i: next(batches), total_size=ds.shape[0], key=6,
            maxiter=STEPS_SVI_STREAM, step_size=0.5, batch_size=B_SVI_STREAM,
            group=16, init_state=init, mesh=m)

    one = make_mesh(devices=[dev])
    xs = x[:100_003]
    st4, path, _ = mesh_fit(tag, lambda: run(mesh),
                            {'B1': nd * STEPS_SVI_STREAM}, STEPS_SVI_STREAM)
    launches['B1-svi-stream-sharded'] = path['B1']
    st1, _, _ = mesh_fit(f'{tag} over one position', lambda: run(one),
                         {'B1': STEPS_SVI_STREAM}, STEPS_SVI_STREAM)
    # from the random start 100 steps of size 0.5 carry the rounding of
    # the first steps' statistics (TF32-split B1 over other tiles) into
    # which component takes which mass: held as two fits of equal quality
    ok_r, what_r = svi_close(model, st4, st1, xs, 1e-3, 1e-2)
    print(f'{tag} from the random start vs one position: {what_r}')
    # from a fitted state the steps stay near the optimum: held tight
    warm = model.fit_vi_fused(x[:ds.shape[0]], key=1, maxiter=20)[0]
    ok_w, what_w = svi_close(model, run(mesh, warm), run(one, warm), xs)
    print(f'{tag} from the VI state of its points vs one position: '
          f'{what_w}')
    check(all_finite(st4) and ok_r and ok_w, f'{tag}: off one position')
    t4 = seconds(lambda: run(mesh), 2)
    t1 = seconds(lambda: run(one), 2)
    print(f'rates on {card}, {tag}: {STEPS_SVI_STREAM / t4:.6g} steps/s '
          f'over the mesh, {STEPS_SVI_STREAM / t1:.6g} over one position '
          f'(median of 2)')
    # one shard of a staged group: step 3's shard 1
    spec = model._estep_spec()
    th, _ = pad_theta(spec.theta(st4.components),
                      st4.gating.expected_log_pi(), torch.float32)
    buf = kernel_xts((x[:16 * B_SVI_STREAM],))[0]
    s, off = N_SHARD_SVI, 3 * B_SVI_STREAM + N_SHARD_SVI
    dev_ms = shard_row('B1-svi-stream-sharded', buf[:, off:off + s], th, s,
                       card, errs, ms)
    STREAM_ROWS['B1-svi-stream-sharded'] = {
        'device_ms': dev_ms,
        'launches_per_step': nd, 'shards': nd, 'shard_n': s,
        'steps_per_s': STEPS_SVI_STREAM / t4,
        'one_position_steps_per_s': STEPS_SVI_STREAM / t1}


def mesh_dense_cell(model, x, mesh, card):
    """Leg (c): the dense fit_vi, fit_map, fit_em and fit_gibbs, 20 sweeps
    each, through data_parallel_fit on the first 1e6 points (phase 17's
    cut) over the (1, 4) mesh, against the unsharded dense fits from the
    same keys: traces within rtol 1e-5 (Gibbs: the cluster mass), no
    kernel launched, one reduction a sweep and the start's."""
    from mimo_tpu_torch.parallel import data_parallel_fit
    from mimo_tpu_torch.parallel import mesh as pmesh
    x1 = x[:min(1_000_000, x.shape[0])]
    n = x1.shape[0]
    tag = (f'dense over a (1, {len(mesh.positions)}) mesh N={n} K={K_MAIN} '
           f'd={D_MAIN} (phase 6 data, cut)')
    starts = {'fit_vi': 2, 'fit_map': 1, 'fit_em': 3, 'fit_gibbs': 1}
    keys = {'fit_vi': 1, 'fit_map': 1, 'fit_em': 0, 'fit_gibbs': 2}
    for name, start in starts.items():
        kw = dict(key=keys[name], maxiter=20)
        if name == 'fit_gibbs':
            kw['track_loglik'] = True
        out, _, t_s = mesh_fit(f'{tag} {name} 20', lambda: data_parallel_fit(
            model, name, x1, mesh=mesh, **kw), {}, 20)
        c = pmesh.counters['start']['calls']
        ref = getattr(model, name)(x1, **kw)
        t_u = seconds(lambda: getattr(model, name)(x1, **kw), 1)
        st, tr = out
        st_u, tr_u = ref
        if name == 'fit_gibbs':
            # the chains differ draw for draw past the first sweep (other
            # shards' labels come from other generators), and 20 sweeps
            # from the prior's labels leave each chain at its own stage of
            # merging components: held by where the mass went, and by the
            # loglik climbing from the start in both
            masses = []
            for lab in (st.labels.gather(), st_u.labels):
                cnt = np.bincount(lab.cpu().numpy(), minlength=K_MAIN)
                masses.append(float(cnt[cnt >= 0.01 * n].sum()) / n)
            ok = (min(masses) >= 0.95 and float(tr[-1]) > float(tr[0])
                  and float(tr_u[-1]) > float(tr_u[0])
                  and all_finite(st.components))
            what = (f'components with >= 1% of the points hold '
                    f'{masses[0]:.4g} of them (unsharded {masses[1]:.4g}; '
                    f'>= 0.95); loglik {float(tr[0]):.9g} -> '
                    f'{float(tr[-1]):.9g} (unsharded {float(tr_u[0]):.9g} '
                    f'-> {float(tr_u[-1]):.9g}; each climbing)')
        else:
            err = float(((tr.double() - tr_u.double()).abs()
                         / tr_u.double().abs()).max())
            ok = err <= 1e-5 and all_finite(st)
            what = f'trace max rel {err:.3g} vs unsharded (rtol 1e-5)'
        print(f'{tag} {name} 20: {what}; start reductions {c} (want '
              f'{start}); {1e3 * t_s / 20:.6g} ms a sweep over the mesh, '
              f'{1e3 * t_u / 20:.6g} unsharded (host clock, one run)')
        check(ok and c == start, f'{tag} {name} off the unsharded fit')


def mesh_dense_chains_cell(model, x, dev):
    """Leg (d): fit_chains of the dense fit_vi 10 over a (2, 2) mesh, 4
    keys, the first 1e6 points, against the unsharded fit_chains: each
    row's two chains batched, one reduction a sweep a row."""
    from mimo_tpu_torch.parallel import make_mesh, shard_data
    m22 = make_mesh(n_chain=2, devices=[dev] * 4)
    xc = x[:N_MESH_SMALL]
    keys = [11, 12, 13, 14]
    (c_s, cv_s), _, _ = mesh_fit(
        f'fit_chains dense VI 10 over a (2, 2) mesh, 4 keys, '
        f'N={N_MESH_SMALL}', lambda: fit_chains(
            model, 'fit_vi', shard_data(m22, xc), keys, mesh=m22,
            maxiter=10), {}, 20)
    c_u, cv_u = fit_chains(model, 'fit_vi', xc, keys, maxiter=10)
    tr = float(((cv_s.double() - cv_u.double()).abs()
                / cv_u.double().abs()).max())
    print(f'fit_chains dense VI (2, 2) vs unsharded: traces max rel '
          f'{tr:.3g} (rtol 1e-5)')
    check(tr <= 1e-5 and all_finite(c_s), 'dense fit_chains over a mesh off')


def mesh_stream_dense_paths(dev, seed, card, n_main, errs, launches, ms):
    """Phase 22: the out-of-core engines and the dense engines over a
    (1, 4) mesh of four positions on this card (legs (a)-(d); leg (e), two
    processes each streaming its own file shard, rides phase 21's
    launch)."""
    from mimo_tpu_torch.parallel import make_mesh
    x = main_data(dev, seed, n_main)
    model = BayesianGMM.make(size=K_MAIN, dim=D_MAIN, gating='dp', alpha=1.0,
                             kappa=0.05, psi_scale=0.5, device=dev)
    mesh = make_mesh(devices=[dev] * 4)
    tmp = tempfile.gettempdir()
    paths = [os.path.join(tmp, f'chip_smoke_mesh_{name}_{os.getpid()}.bin')
             for name in ('main', '2e6')]
    try:
        for path, cell, rows in ((paths[0], mesh_stream_cell, n_main),
                                 (paths[1], mesh_svi_stream_cell, N_STREAM)):
            write_bin(path, x[:rows].cpu().numpy())
            ds = MmapDataset(path)
            try:
                cell(dev, model, x, mesh, ds, card, errs, launches, ms)
            finally:
                ds.close()
                os.unlink(path)
    finally:
        for p in paths:
            if os.path.exists(p):
                os.unlink(p)
    mesh_dense_cell(model, x, mesh, card)
    mesh_dense_chains_cell(model, x, dev)
    del x, model
    torch.cuda.empty_cache()


# -- 23. certify: the samplers, checkpoint / resume, the studies -------------

# leg (a): the largest draw count of at least 1,500 that keeps the leg
# under ~90 s on the card (burn 10%, thin 1; the 8 families at once)
GEWEKE_DRAWS = 4000
GEWEKE_DEADLINE = 300          # seconds for the 8 family processes
CERT_ROWS = {}                 # kernel row -> extra keys of its JSON row
GEWEKE_N, GEWEKE_K, GEWEKE_M = 256, 3, 2
CKPT_TOTAL, CKPT_CHUNK = 20, 5
PRECISION_VI, PRECISION_GIBBS = 50, 10


def geweke_family(family, draws, burn, seed, results):
    """One family of leg (a), in a process of its own on card 0: both
    sides of the Geweke test, the counts set to 0 just before the
    successive side (the transitions) and read just after. Puts the
    record the leg prints and checks on the queue `results` (or the
    traceback of what failed)."""
    try:
        from mimo_tpu_torch.scripts import geweke_gibbs as gw
        torch.cuda.set_device(0)
        dev = torch.device('cuda:0')
        args = gw.parse_args([
            '--backend', 'cuda', '--family', family, '--draws', str(draws),
            '--burn', str(burn), '--thin', '1', '--n', str(GEWEKE_N), '--k',
            str(GEWEKE_K), '--m', str(GEWEKE_M), '--seed', str(seed)])
        cfg = gw.build_config(args, torch.float32, dev)
        g_prior = torch.Generator(device=dev).manual_seed(2 * seed)
        g_succ = torch.Generator(device=dev).manual_seed(2 * seed + 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prior, names = gw.prior_side(cfg, g_prior, draws)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        reset_counts()
        succ = gw.successive_side(cfg, g_succ, draws, burn, 1)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        b2 = sum(cuda_gibbs.launches.values())
        mx, _, bad_p, bad_s = gw.summarize(prior.cpu().double().numpy(),
                                           succ.cpu().double().numpy(),
                                           names, out=lambda s: None)
        results.put({'family': family, 'max_abs_z': mx, 'stats': len(names),
                     'dropped_prior': bad_p, 'dropped_succ': bad_s, 'b2': b2,
                     'prior_s': t1 - t0, 'chain_s': t2 - t1})
    except BaseException:
        import traceback
        results.put({'family': family, 'error': traceback.format_exc()})
        raise


def geweke_leg(dev, seed, card, errs, launches, ms):
    """Leg (a): the Geweke test of the full Gibbs transition of all 8
    families in float32 on the card, the label sweep on B2 (one launch a
    transition), n=256, K=3 (nested M=2 x K=3), at the run's seed. The
    harness is bound by the host (a few hundred small ops a transition),
    so the families run at once, a spawned process each, ended in
    `finally`.
    Fails at any max|z| >= 6.0 (tests/test_diagnostics.py's gate), any
    dropped draw, or a process that fails or outlives the deadline. Then
    the B2-geweke row: B2 at n=256, K=3 on a prior draw of the gmm family,
    against its plain version."""
    import multiprocessing
    import queue
    from mimo_tpu_torch.scripts import geweke_gibbs as gw
    burn = GEWEKE_DRAWS // 10
    steps = GEWEKE_DRAWS + burn
    t_leg = time.perf_counter()
    ctx = multiprocessing.get_context('spawn')
    results = ctx.Queue()
    procs = [ctx.Process(target=geweke_family,
                         args=(f, GEWEKE_DRAWS, burn, seed, results))
             for f in gw.FAMILIES]
    got = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + GEWEKE_DEADLINE
        while len(got) < len(procs):
            left = deadline - time.monotonic()
            check(left > 0, f'Geweke leg: not done in {GEWEKE_DEADLINE} s')
            try:
                r = results.get(timeout=min(left, 5.0))
            except queue.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                check(not dead, f'Geweke leg: a family process exited with '
                      f'{dead} and no result')
                continue
            check('error' not in r, f'Geweke {r["family"]}: {r.get("error")}')
            got[r['family']] = r
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=30)
    total = 0
    for f in gw.FAMILIES:
        r = got[f]
        print(f'Geweke {f} on {card}: B2, float32, n={GEWEKE_N} K={GEWEKE_K}'
              f'{f" M={GEWEKE_M}" if f == "nested" else ""}, '
              f'{GEWEKE_DRAWS} draws, burn {burn}, thin 1: max|z| '
              f'{r["max_abs_z"]:.4g} (< 6.0) over {r["stats"]} statistics; '
              f'dropped prior {r["dropped_prior"]}, successive '
              f'{r["dropped_succ"]}; B2 launches {r["b2"]} (transitions '
              f'{steps}); prior side {r["prior_s"]:.4g} s '
              f'({1e3 * r["prior_s"] / GEWEKE_DRAWS:.4g} ms a draw), chain '
              f'{r["chain_s"]:.4g} s ({1e3 * r["chain_s"] / steps:.4g} ms a '
              f'transition with its data)')
        total += r['b2']
    for f in gw.FAMILIES:
        r = got[f]
        check(r['max_abs_z'] < 6.0 and r['dropped_prior'] == 0
              and r['dropped_succ'] == 0 and r['b2'] == steps,
              f'Geweke {f}: max|z| {r["max_abs_z"]:.4g}, dropped '
              f'{r["dropped_prior"]}/{r["dropped_succ"]}, B2 launches '
              f'{r["b2"]} of {steps} transitions')
    launches['B2-geweke'] = total
    print(f'Geweke leg on {card}: 8 families, a process each, in '
          f'{time.perf_counter() - t_leg:.6g} s, {total} B2 launches')

    # B2 at the leg's shape on a prior draw of the gmm family
    args = gw.parse_args(['--backend', 'cuda', '--n', str(GEWEKE_N), '--k',
                          str(GEWEKE_K)])
    cfg = gw.build_config(args, torch.float32, dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    params, pi = cfg['init'](gen)
    xt = kernel_xts(cfg['generate'](gen, params, pi))[0]
    theta, _ = pad_theta(gaussian_spec().theta_plugin(params),
                         torch.log(torch.clamp(pi, min=1e-37)), torch.float32)
    seed = torch.randint(0, 2 ** 62, (), generator=gen, dtype=torch.int64,
                         device=dev)
    labels, acc = gibbs_labels_check('B2-geweke', xt, theta, seed, GEWEKE_N)
    errs['B2-geweke'] = gibbs_acc_err(xt, GEWEKE_N, cuda_estep.GAUSS, 0,
                                      labels, acc)
    ms['B2-geweke'] = (
        cuda_ms(lambda: cuda_gibbs.gibbs(xt, theta, seed, GEWEKE_N), 20),
        cuda_ms(lambda: cuda_gibbs.gibbs_plain(xt, theta, seed, GEWEKE_N), 3))
    WORK['B2-geweke'] = gibbs_work(
        xt, theta, GEWEKE_N, cuda_estep.feature_width(cuda_estep.GAUSS,
                                                      D_MAIN))
    # at n=256 a call is launch-bound: the profiler's device time stands
    # beside the CUDA-event time of a call, which includes the host's issue
    dev_ms = profiled_device_ms(
        lambda: cuda_gibbs.gibbs(xt, theta, seed, GEWEKE_N))
    CERT_ROWS['B2-geweke'] = {'device_ms': dev_ms}
    print(f'B2-geweke time on {card} at n={GEWEKE_N} K={GEWEKE_K} d={D_MAIN}:'
          f' kernel {ms["B2-geweke"][0]:.6g} ms a call by CUDA events '
          f'(device {ms_text(dev_ms)} by the profiler), plain PyTorch '
          f'{ms["B2-geweke"][1]:.6g} ms')


def checkpoint_leg(dev, seed, card, n_main):
    """Leg (b): fit_with_checkpoints(model, 'fit_vi_fused', ...) on phase
    6's DP-GMM (N=1e7, K=50), 20 sweeps in chunks of 5 into a temporary
    directory: whole; then to 10 and a fresh call with resume=True to 20,
    bitwise the whole run; both against a straight fit_vi_fused 20 from
    the same start by phase 3's rule. B1 exactly 20 launches a run."""
    from mimo_tpu_torch.utils.checkpoint import (
        chunk_key, fit_with_checkpoints, load_state, save_state)
    x = main_data(dev, seed, n_main)
    model = BayesianGMM.make(size=K_MAIN, dim=D_MAIN, gating='dp', alpha=1.0,
                             kappa=0.05, psi_scale=0.5, device=dev)
    tag = f'checkpoint N={n_main} K={K_MAIN} fit_vi_fused {CKPT_TOTAL}'
    with tempfile.TemporaryDirectory() as tmp:
        def chunked(path, total, resume=False):
            torch.cuda.synchronize()
            reset_counts()
            st, ran = fit_with_checkpoints(
                model, 'fit_vi_fused', x, os.path.join(tmp, path),
                total_iters=total, chunk_iters=CKPT_CHUNK, key=seed,
                resume=resume)
            torch.cuda.synchronize()
            return st, ran, read_counts()['B1']

        whole, ran_w, b1_w = chunked('whole', CKPT_TOTAL)
        _, ran_h, b1_h = chunked('split', CKPT_TOTAL // 2)
        again, ran_r, b1_r = chunked('split', CKPT_TOTAL, resume=True)
        bitwise = all(torch.equal(a, b) for a, b in zip(leaves(again),
                                                        leaves(whole)))
        print(f'{tag} in chunks of {CKPT_CHUNK}: whole run {ran_w} sweeps, '
              f'B1 {b1_w} launches; to {CKPT_TOTAL // 2} ({ran_h} sweeps, B1 '
              f'{b1_h}) then resumed by a fresh call ({ran_r} sweeps, B1 '
              f'{b1_r}); resumed state bitwise the whole run {bitwise}')
        check(ran_w == CKPT_TOTAL and b1_w == CKPT_TOTAL
              and ran_h + ran_r == CKPT_TOTAL and b1_h + b1_r == CKPT_TOTAL
              and bitwise, f'{tag}: resume is not the uninterrupted run')
        straight, v = model.fit_vi_fused(x, key=chunk_key(seed, 0),
                                         maxiter=CKPT_TOTAL)
        states_close(tag, whole, straight, v, v,
                     what=f'a straight fit_vi_fused {CKPT_TOTAL}')
        path = os.path.join(tmp, 'timed')
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_state(path, whole)
        t1 = time.perf_counter()
        back = load_state(path, whole)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        check(all(torch.equal(a, b) for a, b in zip(leaves(back),
                                                    leaves(whole))),
              f'{tag}: a saved state does not load back bitwise')
        print(f'{tag}: checkpoint {os.path.getsize(path)} bytes, save '
              f'{1e3 * (t1 - t0):.4g} ms, load onto the card '
              f'{1e3 * (t2 - t1):.4g} ms ({card})')
    del x, model
    torch.cuda.empty_cache()


def smc_study_leg(dev, card):
    """Leg (c): smc_study at its defaults (16 chains, 10 rounds of 10
    sweeps, n=2000, K=4), one seed: both arms scored on held-out points,
    B3 once a chain of each arm."""
    from mimo_tpu_torch.scripts import smc_study
    chains = 16
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    s_ind, s_smc = smc_study.run_seed(0, chains, 10, 10, 2000, dev,
                                      torch.float32)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    b3 = read_counts()['B3']
    arms = {'independent': smc_study.summ(s_ind),
            'smc': smc_study.summ(s_smc)}
    for arm, r in arms.items():
        print(f'smc_study seed 0 on {card}, {arm}: best {r["best"]:+.4f} '
              f'mean {r["mean"]:+.4f} worst {r["worst"]:+.4f} frac_good '
              f'{r["frac_good"]:.3g} (held-out nats/point, {chains} chains)')
    print(f'smc_study: B3 launches {b3} (chains x arms {2 * chains}); '
          f'{secs:.4g} s')
    check(b3 == 2 * chains and np.isfinite(s_ind).all()
          and np.isfinite(s_smc).all(), 'smc_study: scores not finite or '
          'B3 not once a chain')


def precision_study_leg(dev, card, n_main):
    """Leg (d): precision_study at N=1e7, K=50, VI 50 and Gibbs 10: the VI
    held-out mean log predictive of the kernels (B1, B3) within 1e-3
    nats/point of the plain twins'; the Gibbs numbers printed."""
    from mimo_tpu_torch.scripts import precision_study
    res = precision_study.run(n=n_main, vi_iters=PRECISION_VI,
                              gibbs_iters=PRECISION_GIBBS, device=dev,
                              out=lambda s: print(f'precision_study on '
                                                  f'{card}: {s}'))
    delta = abs(res['cuda']['logpred'] - res['plain']['logpred'])
    check(delta <= 1e-3 and res['cuda']['nonfinite'] == 0
          and res['plain']['nonfinite'] == 0,
          f'precision_study: VI held-out delta {delta:.3g} > 1e-3 nats/point')
    torch.cuda.empty_cache()


def certify_paths(dev, seed, card, n_main, errs, launches, ms):
    """Phase 23: legs (a)-(d)."""
    geweke_leg(dev, seed, card, errs, launches, ms)
    checkpoint_leg(dev, seed, card, n_main)
    smc_study_leg(dev, card)
    precision_study_leg(dev, card, n_main)


# -- 24. examples: the drivers on the card ------------------------------------

# the JAX repository's frozen ilr_eval accuracy thresholds, (max RMSE, max
# mean NLPD), copied from tests/test_examples.py:54-63: the worst of a
# 3-seed CPU sweep (seeds 0-2) plus a margin (BENCH_NOTES.md:525-539);
# its test_ilr_eval_accuracy gates seed 0. step is seed-bimodal (RMSE .59
# or .95), both modes under 1.15. The cmb table is not in the repository.
ILR_EVAL_THRESHOLDS = {
    'sine': (0.22, -0.25), 'sinc': (0.26, -0.30), 'step': (1.15, -0.05),
    'step_poly': (3.40, 2.65), 'chirp': (0.62, 0.65),
    'inverse': (0.26, -0.85)}
ILR_EVAL_SEEDS = (0, 1, 2)
# the drivers whose paths run B5 (predict) and B1 (the streamed polish)
B5_DRIVERS = ('ilr_sine', 'ilr_eval', 'ilr_sinc_study', 'hilr')
B1_DRIVERS = ('stream_svi',)
# B5-eval's cells: ilr_eval's sine (N=2,000, K=50, d=1) and step_poly
# (N=160, K=10, cubic features d=3) fits at seed 0
B5_EVAL_ROWS = {'B5-eval': 'sine', 'B5-eval-poly': 'step_poly'}
EXAMPLE_ROWS = {}              # kernel row -> extra keys of its JSON row


def finite_numbers(tree):
    """Every number of a driver's result (dicts of numbers and arrays)
    is finite."""
    if isinstance(tree, dict):
        return all(finite_numbers(v) for v in tree.values())
    return bool(np.isfinite(np.asarray(tree, np.float64)).all())


def jsonable(tree):
    if isinstance(tree, dict):
        return {k: jsonable(v) for k, v in tree.items()}
    a = np.asarray(tree)
    return a.tolist() if a.ndim else a.item()


def run_driver(name, argv):
    """mimo_tpu_torch.examples.<name>.main(argv) on the card, the launch
    counts set to 0 just before and read just after; its own lines pass
    through. Fails if it raises (a driver's own checks raise). Returns
    (its result, wall seconds, the counts)."""
    import importlib
    import traceback
    mod = importlib.import_module(f'mimo_tpu_torch.examples.{name}')
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    try:
        res = mod.main(argv)
    except Exception as e:   # report the driver's failure, then fail
        traceback.print_exc()
        fail(f'example {name} {argv}: {type(e).__name__}: {e}')
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, read_counts()


def drivers_leg(card):
    """(a) every driver at its defaults (its full width), without --plot,
    one after another: wall seconds, the returned numbers, B5 and B1
    launches. Fails when a driver raises, returns a non-finite number, or
    a path of B5 or B1 launches it no time."""
    from mimo_tpu_torch.examples import DRIVERS
    total = 0.0
    for name in DRIVERS:
        res, secs, counts = run_driver(name, [])
        total += secs
        print(f'example {name} on {card}: {secs:.4g} s at its defaults; B5 '
              f'launches {counts["B5"]}, B1 {counts["B1"]}; returned '
              f'{json.dumps(jsonable(res))}')
        check(finite_numbers(res),
              f'example {name}: a returned number is not finite')
        check(name not in B5_DRIVERS or counts['B5'] > 0,
              f'example {name} launched B5 no time')
        check(name not in B1_DRIVERS or counts['B1'] > 0,
              f'example {name} launched B1 no time')
    print(f'examples on {card}: {len(DRIVERS)} drivers in {total:.4g} s')


def ilr_eval_leg(card):
    """(b) ilr_eval on each synthetic dataset at seeds 0, 1 and 2 (the
    data JAX draws: numpy's default_rng(seed)), B5 once a run: the 6 x 3
    table of RMSE and mean NLPD beside the frozen thresholds. Seed 0 of
    every dataset must sit under both (the JAX gate's seed); seeds 1-2
    are reported, a miss marked. Returns B5's launches a dataset."""
    table, launches = {}, {}
    for seed in ILR_EVAL_SEEDS:
        for name in ILR_EVAL_THRESHOLDS:
            res, secs, counts = run_driver(
                'ilr_eval', ['--dataset', name, '--seed', str(seed)])
            r = res[name]
            check(counts['B5'] == 1 and finite_numbers(r),
                  f'ilr_eval {name} seed {seed}: B5 launches '
                  f'{counts["B5"]}, result {r}')
            table[name, seed] = (r['rmse'], r['nlpd'], secs)
            launches[name] = launches.get(name, 0) + counts['B5']
    print(f'ilr_eval on {card}, B5 predict, float32 (thresholds: '
          f'tests/test_examples.py:54-63; JAX gates seed 0):')
    print(f'  {"dataset":10s} {"max RMSE":>8s} {"max NLPD":>8s}' + ''.join(
        f' | seed {s}: {"RMSE":>7s} {"NLPD":>8s} {"s":>6s}'
        for s in ILR_EVAL_SEEDS))
    misses = []
    for name, (max_rmse, max_nlpd) in ILR_EVAL_THRESHOLDS.items():
        cells = ''
        for seed in ILR_EVAL_SEEDS:
            rmse, nlpd, secs = table[name, seed]
            under = rmse < max_rmse and nlpd < max_nlpd
            if not under:
                misses.append((name, seed, rmse, nlpd))
            cells += (f' | {"":6s}  {rmse:7.4f} {nlpd:8.4f} {secs:6.3f}'
                      f'{"" if under else " MISS"}')
        print(f'  {name:10s} {max_rmse:8.3f} {max_nlpd:8.3f}{cells}')
    print(f'ilr_eval misses at seeds 1-2: '
          f'{[m for m in misses if m[1] != 0] or "none"}')
    gate = [m for m in misses if m[1] == 0]
    check(not gate, f'ilr_eval seed 0 over the frozen thresholds: {gate}')
    return launches


def b5_eval_rows(dev, card, per_dataset, errs, launches, ms):
    """(c) B5 against its plain twin at ilr_eval's shapes: the sine and
    step_poly fits at seed 0 (ilr_eval.fit, the driver's recipe),
    standardized (x, y) with y, average prediction; timed by CUDA events
    and, launch-bound at these sizes, by the profiler's device time. A
    row's launches are B5's on (b)'s runs of its dataset."""
    from mimo_tpu_torch.examples import ilr_eval
    for row, name in B5_EVAL_ROWS.items():
        args, _ = ilr_eval.parse(['--dataset', name, '--seed', '0'])
        model, state, _, x, y = ilr_eval.fit(name, args, dev)
        basis, experts = state.components
        th, aux = cuda_ilr_predict.ilr_predict_coefficients(
            basis, experts, model.predictive_log_weights(state),
            model.affine)
        th, aux = th.to(torch.float32), aux.to(torch.float32)
        xt = stack_rows(kernel_xts((model._tx(x), model._ty(y))))
        n, d, k = x.shape[0], x.shape[1], model.size
        out = cuda_ilr_predict.ilr_predict(xt, th, aux, n, True, False)
        ref = cuda_ilr_predict.ilr_predict_plain(xt, th, aux, n, True, False)
        torch.cuda.synchronize()
        ok, errs[row], flips = compare_serving(out, ref, 1, False)
        print(f'{row} ({name}, N={n} K={k} d={d}, fitted): max|err| '
              f'{errs[row]:.6g} (mean rtol/atol 1e-4, var 2e-3/1e-5, nlpd '
              f'1e-3/2e-3, lse_w 1e-5/1e-4); points off {flips} '
              f'{"ok" if ok else "FAIL"}')
        check(ok, f'{row} disagrees with its plain twin')
        ms[row] = (cuda_ms(lambda: cuda_ilr_predict.ilr_predict(
                       xt, th, aux, n, True, False), 20),
                   cuda_ms(lambda: cuda_ilr_predict.ilr_predict_plain(
                       xt, th, aux, n, True, False), 3))
        dev_ms = profiled_device_ms(lambda: cuda_ilr_predict.ilr_predict(
            xt, th, aux, n, True, False))
        WORK[row] = serving_work(n, k, d, 1)
        launches[row] = per_dataset[name]
        EXAMPLE_ROWS[row] = {'device_ms': dev_ms, 'n': n, 'k': k, 'd': d}
        print(f'{row} time on {card} at N={n} K={k} d={d}: kernel '
              f'{ms[row][0]:.6g} ms a call by CUDA events (device '
              f'{ms_text(dev_ms)} by the profiler), plain PyTorch '
              f'{ms[row][1]:.6g} ms; B5 launches on ilr_eval\'s {name} '
              f'runs {launches[row]}')
        del model, state, x, y, xt


def examples_paths(dev, card, errs, launches, ms):
    """Phase 24: legs (a)-(c)."""
    drivers_leg(card)
    per_dataset = ilr_eval_leg(card)
    b5_eval_rows(dev, card, per_dataset, errs, launches, ms)
    torch.cuda.empty_cache()



# -- 25. the ILR map over a diagonal basis ------------------------------------

N_DB_WIDE = 10_000_000         # the d=1 cell of B1/B2 over ILR_DIAG
DB_SWEEPS = 10                 # the fit path's Gibbs and VI sweeps


def random_diag_basis_posterior(gen, k, d, p, affine, dev):
    """An (NG, MNW) posterior at random_ilr_posterior's scales: the NG
    basis over the data's range [-3, 3]^d, the MNW experts over [x; 1] (or
    x, without the experts' ones column)."""
    basis = random_ng_posterior(gen, k, d, dev)._replace(
        mu=torch.rand((k, d), generator=gen, device=dev) * 6 - 3)
    _, experts = random_ilr_posterior(gen, k, d, p, dev)
    q = d + int(affine)
    return basis, experts._replace(M=experts.M[..., :q],
                                   K_=experts.K_[..., :q, :q])


def diag_basis_model(k, d, p, affine, dev):
    """A mixture of linear experts over a diagonal (NG) basis: the product
    family that ilr_spec(diag_basis=True) describes, run by
    BayesianMixture's fused engines over that spec. No model class builds
    it, in the port or in mimo_tpu (whose ILR basis is NIW or HierTied)."""
    model = BayesianMixture(
        StickBreaking.standard(k, 2.0, device=dev),
        (NG.standard(k, d, kappa=0.05, device=dev),
         MNW.standard(k, p, d + int(affine), device=dev)),
        product_family((diag_gaussian_family(), linear_family(affine)),
                       ((0,), (0, 1))))
    model._estep_spec = lambda: ilr_spec(d, p, affine=affine,
                                         diag_basis=True)
    return model


def diag_basis_paths(dev, seed, card, errs, launches, ms):
    """Phase 25: B1 and B2 over the ILR map on a diagonal basis (ILR_DIAG
    with the experts' ones column, ILR_DIAG_LINEAR without) against their
    plain versions at N=1,000,003, K=50, d=8, p=1 (m8=112) and N=1e7, d=1,
    p=1, each with B1's precision line; then its fit path (N=1e6, d=8):
    fit_gibbs_fused then fit_vi_fused from the Gibbs state, DB_SWEEPS
    each, B1 and B2 exactly DB_SWEEPS launches each, kernel vs plain on
    100,003 points, and each kernel's time at the fitted state."""
    gen = torch.Generator(device=dev).manual_seed(seed + 25)
    errs['B1-ILR-diagbasis'] = errs['B2-ILR-diagbasis'] = 0.0
    for n, d in ((N_CHECK, D_Q8), (N_DB_WIDE, 1)):
        for affine in (True, False):
            kind = ILR_DIAG if affine else ILR_DIAG_LINEAR
            fam = product_family((diag_gaussian_family(),
                                  linear_family(affine)), ((0,), (0, 1)))
            spec = ilr_spec(d, 1, affine=affine, diag_basis=True)
            post = random_diag_basis_posterior(gen, K_MAIN, d, 1, affine,
                                               dev)
            log_pi = torch.log_softmax(torch.randn((K_MAIN,), generator=gen,
                                                   device=dev), 0)
            xt = stack_rows(kernel_xts(regression_data(gen, n, d, 1, dev)))
            theta, _ = pad_theta(spec.theta(post), log_pi, torch.float32)
            cell = (f'N={n} K={K_MAIN} d={d} p=1 '
                    f'{"affine" if affine else "linear"} m8={theta.shape[1]}')
            acc, lse = cuda_estep.estep(xt, theta, n, kind, 1)
            acc2, lse2 = cuda_estep.estep(xt, theta, n, kind, 1)
            pacc, plse = cuda_estep.estep_plain(xt, theta, n, kind, 1)
            mag = estep_magnitudes(xt, theta, n, kind, 1)
            torch.cuda.synchronize()
            err = (acc.double() - pacc.double()).abs()
            ok_s = bool((err <= 1e-5 * mag + 1e-6).all())
            ok_l, err_l = allclose_report(lse, plse, 1e-5, 0.0)
            bitwise = torch.equal(acc, acc2) and torch.equal(lse, lse2)
            print(f'B1-ILR-diagbasis {cell}: stats max|err| '
                  f'{float(err.max()):.6g}, max |err| / summed magnitude '
                  f'{float((err / mag.clamp(min=1e-30)).max()):.3g} '
                  f'(<= 1e-5) {"ok" if ok_s else "FAIL"}; lse '
                  f'{float(lse):.9g} vs {float(plse):.9g}, |err| '
                  f'{err_l:.6g} (rtol 1e-5) {"ok" if ok_l else "FAIL"}; '
                  f'bitwise repeat {bitwise}')
            check(ok_s and ok_l and bitwise
                  and bool(torch.isfinite(acc).all()),
                  f'B1-ILR-diagbasis disagrees at {cell}')
            errs['B1-ILR-diagbasis'] = max(errs['B1-ILR-diagbasis'],
                                           float(err.max()))
            precision_check(f'ILR diagonal basis {cell}', xt, theta, n, kind,
                            1, got=(acc, lse))
            del acc, acc2, pacc, mag, err
            th_g, _ = pad_theta(spec.theta_plugin(fam.mode_params(post)),
                                log_pi, torch.float32)
            sweep_seed = torch.randint(0, 2 ** 62, (), generator=gen,
                                       device=dev)
            labels, gacc = gibbs_labels_check(
                f'B2-ILR-diagbasis d={d} p=1 '
                f'{"affine" if affine else "linear"} m8={th_g.shape[1]}',
                xt, th_g, sweep_seed, n, kind, 1)
            errs['B2-ILR-diagbasis'] = max(
                errs['B2-ILR-diagbasis'],
                gibbs_acc_err(xt, n, kind, 1, labels, gacc))
            del xt, labels
            torch.cuda.empty_cache()

    kg = torch.Generator(device=dev).manual_seed(seed + 26)
    x, y = regression_data(kg, N_Q8, D_Q8, 1, dev)
    model = diag_basis_model(K_MAIN, D_Q8, 1, True, dev)
    tag = f'ILR diagonal-basis fit N={N_Q8} K={K_MAIN} d={D_Q8} p=1'
    torch.cuda.synchronize()
    reset_counts()
    gs = model.fit_gibbs_fused((x, y), key=2, maxiter=DB_SWEEPS)
    st, vlb = model.fit_vi_fused((x, y), key=1, maxiter=DB_SWEEPS,
                                 init_state=MFState(gs.components, gs.gating),
                                 randomize=False)
    torch.cuda.synchronize()
    path = read_counts()
    launches.update({b: path[b] for b in ('B1-ILR-diagbasis',
                                          'B2-ILR-diagbasis')})
    print(f'{tag}: launches {path}')
    check(path['B1-ILR-diagbasis'] == DB_SWEEPS
          and path['B2-ILR-diagbasis'] == DB_SWEEPS
          and sum(path.values()) == 2 * DB_SWEEPS,
          'the diagonal-basis fit path bypassed a kernel')
    elbo_report(f'{tag} VI', vlb)
    check(all_finite(st) and all_finite(gs[:4])
          and int(gs.labels.min()) >= 0 and int(gs.labels.max()) < K_MAIN,
          'diagonal-basis state not finite or labels out of range')
    xs_, ys_ = x[:100_003], y[:100_003]
    _, v_k = model.fit_vi_fused((xs_, ys_), maxiter=5, init_state=st,
                                randomize=False, backend='kernel')
    _, v_t = model.fit_vi_fused((xs_, ys_), maxiter=5, init_state=st,
                                randomize=False, backend='torch')
    ok_v, e_v = allclose_report(v_k, v_t, 1e-4, 0.0)
    print(f'{tag} vs plain on 100,003 points: VI ELBO max|err| {e_v:.6g} '
          f'(rtol 1e-4) {"ok" if ok_v else "FAIL"}')
    check(ok_v, 'the diagonal-basis kernel path disagrees with the plain '
          'path')
    vi = rate(DB_SWEEPS, lambda: model.fit_vi_fused(
        (x, y), maxiter=DB_SWEEPS, init_state=st, randomize=False))
    gibbs = rate(DB_SWEEPS, lambda: model.fit_gibbs_fused(
        (x, y), key=3, maxiter=DB_SWEEPS))
    print(f'rates on {card}, {tag}: VI {vi} it/s; Gibbs {gibbs} sweeps/s')

    spec = model._estep_spec()
    xt = stack_rows(kernel_xts((x, y)))
    th_vi, _ = pad_theta(spec.theta(st.components),
                         st.gating.expected_log_pi(), torch.float32)
    th_g, _ = pad_theta(spec.theta_plugin(gs.params), gs.log_pi,
                        torch.float32)
    sweep_seed = torch.zeros((), dtype=torch.int64, device=dev)
    pairs = {
        'B1-ILR-diagbasis': (
            lambda: cuda_estep.estep(xt, th_vi, N_Q8, ILR_DIAG, 1),
            lambda: cuda_estep.estep_plain(xt, th_vi, N_Q8, ILR_DIAG, 1)),
        'B2-ILR-diagbasis': (
            lambda: cuda_gibbs.gibbs(xt, th_g, sweep_seed, N_Q8, ILR_DIAG,
                                     1),
            lambda: cuda_gibbs.gibbs_plain(xt, th_g, sweep_seed, N_Q8,
                                           ILR_DIAG, 1)),
    }
    m = cuda_estep.feature_width(ILR_DIAG, D_Q8, 1)
    WORK.update({'B1-ILR-diagbasis': estep_work(N_Q8, K_MAIN, m, D_Q8 + 1),
                 'B2-ILR-diagbasis': gibbs_work(xt, th_g, N_Q8, m, ILR_DIAG,
                                                1)})
    for name, (kern, plain) in pairs.items():
        ms[name] = (cuda_ms(kern, 20), cuda_ms(plain, 3))
        print(f'{name} time on {card} at N={N_Q8} K={K_MAIN} d={D_Q8} p=1 '
              f'm8={th_vi.shape[1]}: kernel {ms[name][0]:.6g} ms, plain '
              f'PyTorch {ms[name][1]:.6g} ms')
    precision_check(f'ILR diagonal basis fit N={N_Q8} K={K_MAIN} d={D_Q8} '
                    f'p=1 m8={th_vi.shape[1]}', xt, th_vi, N_Q8, ILR_DIAG, 1)
    del x, y, xt, model, st, gs
    torch.cuda.empty_cache()


# -- 26. the dense engines over chains ----------------------------------------

N_DENSE_CHAINS, K_DENSE_CHAINS = 1_000_000, 16
DENSE_SWEEPS = 10
DENSE_SVI = dict(maxiter=100, step_size=0.5, batch_size=256)


def dense_chain_engine(tag, model, data, engine, kw, card, check_kw=None,
                       keys=tuple(range(101, 101 + C_MAIN))):
    """fit_chains of a dense engine over C keys as one program against the
    C serial fits with the same keys: traces within rtol 1e-5 of the
    serial fits' (`check_kw`, where given, runs the check: SVI tracks its
    ELBO there), every state finite, no kernel launched; then the batched
    and the serial seconds at `kw`, each the median of 3 runs. Returns
    (batched, serial) seconds."""
    keys = list(keys)
    ck = kw if check_kw is None else check_kw
    out, _, _ = nested_fit(f'{tag} fit_chains {engine} C={len(keys)}',
                           lambda: fit_chains(model, engine, data, keys,
                                              **ck), {})
    st, tr = out
    serial = stack_trees([getattr(model, engine)(data, key=k, **ck)
                          for k in keys])
    ok_v, e_v = allclose_report(tr, serial[1], 1e-5, 0.0)
    rel = relative_leaves(st, serial[0])
    t_b = seconds(lambda: fit_chains(model, engine, data, keys, **kw))
    t_s = seconds(lambda: [getattr(model, engine)(data, key=k, **kw)
                           for k in keys])
    print(f'{tag} {engine} C={len(keys)} vs the serial fits with the same '
          f'keys: traces max|err| {e_v:.6g} (rtol 1e-5) '
          f'{"ok" if ok_v else "FAIL"}, state leaves max|err| / largest '
          f'magnitude {rel:.3g}; finite {all_finite(st)}; seconds on '
          f'{card} (median of 3): batched {t_b:.6g}, serial {t_s:.6g} '
          f'({t_s / t_b:.3g}x)')
    check(ok_v and all_finite(st) and bool(torch.isfinite(tr).all()),
          f'{tag} {engine}: chains off their serial fits or not finite')
    return t_b, t_s


def dense_chain_paths(dev, seed, card):
    """Phase 26: every dense engine batched over C=8 chains (fit_chains of
    fit_vi, fit_map, fit_em DENSE_SWEEPS sweeps and fit_svi 100 steps at
    B=256; the check's SVI tracks its ELBO over 20 steps) at
    examples/chains_smc.py's cell (N=1e4, K=10, DP-GMM) and at N=1e6,
    K=16 (phase 6's data), each chain held against its serial fit; the
    nested dense VI and ML-EM at phase 18's nested cell (N=1e6, M=4, K=8,
    5 sweeps), and the dense ILR VI at the sine shape (N=1e6, K=50, d=1,
    p=1); batched and serial seconds of each."""
    svi_check = dict(DENSE_SVI, maxiter=20, track_elbo=True)
    engines = [('fit_vi', dict(maxiter=DENSE_SWEEPS), None),
               ('fit_map', dict(maxiter=DENSE_SWEEPS), None),
               ('fit_em', dict(maxiter=DENSE_SWEEPS), None),
               ('fit_svi', DENSE_SVI, svi_check)]
    kg = torch.Generator(device=dev).manual_seed(seed + 5)
    mu = torch.tensor([[-4., 0.], [4., 0.], [0., 5.]], device=dev)
    lm = torch.eye(2, device=dev).expand(3, 2, 2) * 2.0
    x_smc, _ = BayesianGMM.generate(kg, GaussParams(mu, lm), [.3, .4, .3],
                                    N_SMC)
    cells = [(f'dense chains N={N_SMC} K=10', BayesianGMM.make(
        size=10, dim=2, gating='dp', kappa=0.05, psi_scale=0.5, device=dev),
        x_smc),
        (f'dense chains N={N_DENSE_CHAINS} K={K_DENSE_CHAINS}',
         BayesianGMM.make(size=K_DENSE_CHAINS, dim=D_MAIN, gating='dp',
                          kappa=0.05, psi_scale=0.5, device=dev),
         main_data(dev, seed, N_DENSE_CHAINS))]
    for tag, model, x in cells:
        for engine, kw, ck in engines:
            dense_chain_engine(tag, model, x, engine, kw, card, ck)
    del cells
    torch.cuda.empty_cache()

    xn = nested_blobs(torch.Generator(device=dev).manual_seed(seed + 18),
                      1_000_000, dev)
    nested = BayesianMixtureOfMixtures.make_gmm(
        4, 8, 2, hierarchical=False, kappa=0.5, psi_scale=0.5, device=dev)
    for engine in ('fit_vi', 'fit_em'):
        dense_chain_engine('nested dense chains N=1e6 M=4 K=8', nested, xn,
                           engine, dict(maxiter=5, maxsubiter=2), card)
    del xn, nested
    torch.cuda.empty_cache()

    kg = torch.Generator(device=dev).manual_seed(seed + 9)
    xs = torch.rand((N_DENSE_CHAINS, 1), generator=kg, device=dev) * 12 - 6
    ys = torch.sin(xs) + 0.1 * torch.randn(xs.shape, generator=kg,
                                           device=dev)
    ilr = BayesianILR.make(size=K_MAIN, input_dim=1, output_dim=1,
                           alpha=2.0, kappa=0.05, device=dev)
    ilr.init_transform(xs, ys)
    dense_chain_engine(f'dense ILR chains N={N_DENSE_CHAINS} K={K_MAIN} d=1 '
                       f'p=1', ilr, (xs, ys), 'fit_vi',
                       dict(maxiter=DENSE_SWEEPS), card)
    del xs, ys, ilr
    torch.cuda.empty_cache()


# -- 27. fed: bench.py's MXU-fed shapes through the streamed layout ---------

# (tag, N, K, d, VI, Gibbs, MAP, ML-EM, fit_chains VI sweeps at C=2,
# log_predictive): bench.py:296-312's two cells and the d=16, K=128 shape
# between them (mimo_tpu/ops/family_estep.py:74-79)
FED_CELLS = (('d8', 10_000_000, 128, 8, 50, 50, 0, 0, 0, False),
             ('d16', 1_000_000, 128, 16, 20, 20, 20, 0, 5, False),
             ('d32', 1_000_000, 256, 32, 20, 5, 0, 5, 0, True))
FED_RATE_SWEEPS = 5             # sweeps a timed run of the rates
N_FED_ILR, K_FED_ILR, D_FED_ILR = 1_000_003, 50, 16
FED_ILR_SWEEPS = 5
FED_ROWS = {}                   # kernel row -> its cell's description


def fed_data(gen, n, d, dev):
    """bench.py:90-98's data at d: 3 clusters, mu ~ 4 N(0, I), Lambda =
    2 I, weights .3 / .4 / .3."""
    mu = torch.randn((3, d), generator=gen, device=dev) * 4.0
    lm = torch.eye(d, device=dev).expand(3, d, d) * 2.0
    return BayesianGMM.generate(gen, GaussParams(mu, lm), [.3, .4, .3],
                                n)[0], mu


def fed_b1_checks(tag, xt, theta, n, kind=cuda_estep.GAUSS, p=0):
    """B1 at a fitted theta: bitwise on repeat, lse within rtol 1e-5 of
    its plain version, and its precision line against float64 (at most
    10x the f32 plain version's error: the check of its rounding). The
    statistics against the plain version: printed by phase 3's rule
    (rtol 1e-4 of each value) and by each entry's share of its summed
    magnitude sum_n r_nk |F_jn|: at d >= 16 the f32 plain version's own
    error reaches 3.6e-5 (the ILR map) to 2.2e-4 (d=32) of it where
    components share points (its f32 logits are off by ~1e-3 nats there),
    so the check takes 1e-3 of it. Returns max |err|."""
    acc, lse = cuda_estep.estep(xt, theta, n, kind, p)
    acc2, lse2 = cuda_estep.estep(xt, theta, n, kind, p)
    precision_check(tag, xt, theta, n, kind, p, got=(acc, lse))
    pacc, plse = cuda_estep.estep_plain(xt, theta, n, kind, p)
    mag = estep_magnitudes(xt, theta, n, kind, p)
    atol = 1e-3 * n / 1e6
    rtol = 1e-3
    diff = (acc.double() - pacc.double()).abs()
    ok_s = bool((diff <= rtol * mag + atol).all())
    ok_3, err = allclose_report(acc, pacc, 1e-4, atol)
    w = int(torch.argmax(diff / (1e-4 * pacc.double().abs() + atol)))
    ok_l, err_l = allclose_report(lse, plse, 1e-5, 0.0)
    bitwise = torch.equal(acc, acc2) and torch.equal(lse, lse2)
    print(f'{tag} B1 vs plain: stats max|err| {err:.6g}, max |err| / summed '
          f'magnitude {float((diff / mag.clamp(min=1e-30)).max()):.3g} '
          f'(<= {rtol:g}, atol {atol:.6g}) {"ok" if ok_s else "FAIL"}; by '
          f'phase 3\'s rule (rtol 1e-4 of the values) '
          f'{"ok" if ok_3 else "not met"}, its worst entry '
          f'{float(pacc.flatten()[w]):.6g} off by '
          f'{float(diff.flatten()[w]):.6g} (summed magnitude '
          f'{float(mag.flatten()[w]):.6g}); lse {float(lse):.9g} vs '
          f'{float(plse):.9g}, |err| {err_l:.6g} (rtol 1e-5) '
          f'{"ok" if ok_l else "FAIL"}; bitwise repeat {bitwise}')
    check(ok_s and ok_l and bitwise and bool(torch.isfinite(acc).all()),
          f'{tag}: B1 disagrees')
    return err


def fed_rows(card, tag, rows, ms):
    """Time each (row, kernel, plain, work, what) of a cell: the kernel by
    CUDA events (10 launches after 2 warm-ups), its plain version (2 after
    1)."""
    for name, kern, plain, work, what in rows:
        WORK[name] = work
        FED_ROWS[name] = what
        ms[name] = (cuda_ms(kern, 10), cuda_ms(plain, 2, warm=1))
        print(f'{name} time on {card}, {tag}: kernel {ms[name][0]:.6g} ms, '
              f'plain PyTorch {ms[name][1]:.6g} ms')


def fed_gmm_cell(dev, seed, card, errs, launches, ms, cell):
    tag, n, k, d, n_vi, n_gibbs, n_map, n_em, n_chain, predict = cell
    kg = torch.Generator(device=dev).manual_seed(seed + 27)
    x, mu = fed_data(kg, n, d, dev)
    model = BayesianGMM.make(size=k, dim=d, gating='dp', alpha=1.0,
                             kappa=0.05, psi_scale=0.5, device=dev)
    name = f'fed N={n} K={k} d={d}'
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reset_counts()
    st, vlb = model.fit_vi_fused(x, key=1, maxiter=n_vi)
    gs = model.fit_gibbs_fused(x, key=2, maxiter=n_gibbs)
    traces = {}
    if n_map:
        traces['MAP-EM'] = model.fit_map_fused(x, key=3, maxiter=n_map)
    if n_em:
        traces['ML-EM'] = model.fit_em_fused(x, key=4, maxiter=n_em)
    if n_chain:
        traces['fit_chains VI'] = fit_chains(model, 'fit_vi_fused', x,
                                             [5, 6], maxiter=n_chain)
    lp = model.log_predictive(st, x) if predict else None
    torch.cuda.synchronize()
    path = read_counts()
    want = {'B1': n_vi + n_map + n_em + n_chain, 'B2': n_gibbs,
            'B3': int(predict)}
    print(f'{name}: VI {n_vi}, Gibbs {n_gibbs}, MAP {n_map}, ML-EM {n_em}, '
          f'fit_chains VI {n_chain} at C=2, log_predictive {predict}: '
          f'{time.perf_counter() - t0:.6g} s, launches {path} (expected '
          f'{want}, exactly one a sweep)')
    check(all(path[b] == c for b, c in want.items())
          and sum(path.values()) == sum(want.values()),
          f'{name}: the path bypassed a kernel or launched more than one a '
          'sweep')
    launches.update({f'B1-fed-{tag}': want['B1'], f'B2-fed-{tag}': n_gibbs})
    if predict:
        launches[f'B3-fed-{tag}'] = 1
    elbo_report(f'{name} VI', vlb)
    for what, (state, trace) in traces.items():
        check(all_finite(state), f'{name} {what}: state not finite')
        if what == 'ML-EM':
            elbo_report(f'{name} {what}', trace, 'loglik')
        elif what == 'fit_chains VI':
            for c in range(trace.shape[0]):
                elbo_report(f'{name} {what} chain {c}', trace[c])
        else:
            check(bool(torch.isfinite(trace).all()),
                  f'{name} {what}: trace not finite')
            print(f'{name} {what}: loglik {float(trace[0]):.9g} -> '
                  f'{float(trace[-1]):.9g}, finite')
    check(all_finite(st) and all_finite(gs[:4])
          and int(gs.labels.min()) >= 0 and int(gs.labels.max()) < k,
          f'{name}: state not finite or labels out of range')
    w_vi = st.gating.mean()
    top = torch.argsort(w_vi, descending=True)[:3]
    dist_mu = torch.cdist(mu, st.components.mu[top]).min(1).values
    print(f'{name} fit: VI top-3 weights '
          f'{[round(float(w), 4) for w in w_vi[top]]}, true means within '
          f'{float(dist_mu.max()):.4g}')
    if predict:
        check(lp.shape == (n,) and bool(torch.isfinite(lp).all()),
              f'{name}: log_predictive not finite')

    xs_ = x[:100_003]
    _, v_k = model.fit_vi_fused(xs_, maxiter=5, init_state=st,
                                randomize=False, backend='kernel')
    _, v_t = model.fit_vi_fused(xs_, maxiter=5, init_state=st,
                                randomize=False, backend='torch')
    ok_v, e_v = allclose_report(v_k, v_t, 1e-4, 0.0)
    msg = f'VI ELBO max|err| {e_v:.6g} (rtol 1e-4) {"ok" if ok_v else "FAIL"}'
    if predict:
        lp_k = model.log_predictive(st, xs_, backend='kernel')
        _, e_p = allclose_report(
            lp_k, model.log_predictive(st, xs_, backend='torch'), 1e-5, 1e-4)
        msg += (f'; log_predictive max|err| {e_p:.6g} nats, finite '
                f'{bool(torch.isfinite(lp_k).all())} (B3\'s float64 lines '
                f'below decide: at d=32 the f32 quadratic forms of both '
                f'versions cancel terms of ~1e3)')
        check(bool(torch.isfinite(lp_k).all()), f'{name}: log_predictive '
              'not finite on the slice')
    print(f'{name} vs plain on 100,003 points: {msg}')
    check(ok_v, f'{name}: the kernel path disagrees with the plain path')
    vi = rate(FED_RATE_SWEEPS, lambda: model.fit_vi_fused(
        x, maxiter=FED_RATE_SWEEPS, init_state=st, randomize=False), reps=3)
    gibbs = rate(FED_RATE_SWEEPS, lambda: model.fit_gibbs_fused(
        x, key=3, maxiter=FED_RATE_SWEEPS), reps=3)
    print(f'rates on {card}, {name}: VI {vi} it/s, Gibbs {gibbs} sweeps/s '
          f'({FED_RATE_SWEEPS} warm sweeps a run)')

    spec = model._estep_spec()
    xt = kernel_xts((x,))[0]
    th_vi, _ = pad_theta(spec.theta(st.components),
                         st.gating.expected_log_pi(), torch.float32)
    th_g, _ = pad_theta(spec.theta_plugin(gs.params), gs.log_pi,
                        torch.float32)
    errs[f'B1-fed-{tag}'] = fed_b1_checks(name, xt, th_vi, n)
    sweep_seed = torch.randint(0, 2 ** 62, (), generator=kg, device=dev)
    labels, gacc = gibbs_labels_check(f'{name} B2', xt, th_g, sweep_seed, n)
    errs[f'B2-fed-{tag}'] = gibbs_acc_err(xt, n, cuda_estep.GAUSS, 0, labels,
                                          gacc)
    del labels, gacc
    m = cuda_estep.feature_width(cuda_estep.GAUSS, d)
    rows = [(f'B1-fed-{tag}', lambda: cuda_estep.estep(xt, th_vi, n),
             lambda: cuda_estep.estep_plain(xt, th_vi, n),
             estep_work(n, k, m, d), f'{name}, VI theta'),
            (f'B2-fed-{tag}', lambda: cuda_gibbs.gibbs(xt, th_g, sweep_seed, n),
             lambda: cuda_gibbs.gibbs_plain(xt, th_g, sweep_seed, n),
             gibbs_work(xt, th_g, n, m), f'{name}, plug-in theta')]
    if predict:
        thq, aux = cuda_predict.predictive_coefficients(
            st.components, model.predictive_log_weights(st))
        out = cuda_predict.predict(xt, thq, aux, n)
        _, e = allclose_report(out, cuda_predict.predict_plain(
            xt, thq, aux, n), 1e-5, 1e-4)
        errs[f'B3-fed-{tag}'] = e
        print(f'{name} B3 Student-t vs plain: max|err| {e:.6g} nats; finite '
              f'{bool(torch.isfinite(out).all())}')
        check(bool(torch.isfinite(out).all()), f'{name}: B3 not finite')
        for cell_n, cell in ((min(n, 100_003), 'the first 100,003 points'),
                             (n, f'all {n} points')):
            serving_precision('B3', f'{name}, {cell}', cuda_predict.predict,
                              cuda_predict.predict_plain,
                              (xt, thq, aux, cell_n),
                              (('nats', 'log density'),))
        rows.append((f'B3-fed-{tag}',
                     lambda: cuda_predict.predict(xt, thq, aux, n),
                     lambda: cuda_predict.predict_plain(xt, thq, aux, n),
                     density_work(n, k, quad_fmas(d), d, 2,
                                  products=point_products(d)),
                     f'{name}, the VI state'))
    fed_rows(card, name, rows, ms)
    del x, xt, model, st, gs, traces, lp
    torch.cuda.empty_cache()


def fed_ilr_cell(dev, seed, card, errs, launches, ms):
    """B1 and B2 over the ILR map at d=16, p=1 (m8 = 584) on its fit path:
    fit_gibbs_fused, then fit_vi_fused from its state."""
    kg = torch.Generator(device=dev).manual_seed(seed + 28)
    n, k, d = N_FED_ILR, K_FED_ILR, D_FED_ILR
    x, y = regression_data(kg, n, d, 1, dev)
    model = BayesianILR.make(size=k, input_dim=d, output_dim=1, alpha=2.0,
                             kappa=0.05, device=dev)
    name = f'fed ILR N={n} K={k} d={d} p=1'
    torch.cuda.synchronize()
    reset_counts()
    gs = model.fit_gibbs_fused((x, y), key=2, maxiter=FED_ILR_SWEEPS)
    st, vlb = model.fit_vi_fused((x, y), key=1, maxiter=FED_ILR_SWEEPS,
                                 init_state=MFState(gs.components, gs.gating),
                                 randomize=False)
    torch.cuda.synchronize()
    path = read_counts()
    print(f'{name}: Gibbs {FED_ILR_SWEEPS} -> VI {FED_ILR_SWEEPS}, launches '
          f'{path}')
    check(path['B1-ILR'] == FED_ILR_SWEEPS
          and path['B2-ILR'] == FED_ILR_SWEEPS
          and sum(path.values()) == 2 * FED_ILR_SWEEPS,
          f'{name}: the fit path bypassed a kernel')
    launches.update({'B1-fed-ilr16': FED_ILR_SWEEPS,
                     'B2-fed-ilr16': FED_ILR_SWEEPS})
    elbo_report(f'{name} VI', vlb)
    check(all_finite(st) and all_finite(gs[:4]),
          f'{name}: state not finite')
    xs_, ys_ = x[:100_003], y[:100_003]
    _, v_k = model.fit_vi_fused((xs_, ys_), maxiter=5, init_state=st,
                                randomize=False, backend='kernel')
    _, v_t = model.fit_vi_fused((xs_, ys_), maxiter=5, init_state=st,
                                randomize=False, backend='torch')
    ok_v, e_v = allclose_report(v_k, v_t, 1e-4, 0.0)
    print(f'{name} vs plain on 100,003 points: VI ELBO max|err| {e_v:.6g} '
          f'(rtol 1e-4) {"ok" if ok_v else "FAIL"}')
    check(ok_v, f'{name}: the kernel path disagrees with the plain path')
    spec = model._estep_spec()
    xt = stack_rows(kernel_xts((x, y)))
    th_vi, _ = pad_theta(spec.theta(st.components),
                         st.gating.expected_log_pi(), torch.float32)
    th_g, _ = pad_theta(spec.theta_plugin(gs.params), gs.log_pi,
                        torch.float32)
    check(th_vi.shape[1] == 584, f'{name}: m8 {th_vi.shape[1]}, not 584')
    errs['B1-fed-ilr16'] = fed_b1_checks(name, xt, th_vi, n, ILR, 1)
    sweep_seed = torch.randint(0, 2 ** 62, (), generator=kg, device=dev)
    labels, gacc = gibbs_labels_check(f'{name} B2', xt, th_g, sweep_seed, n,
                                      ILR, 1)
    errs['B2-fed-ilr16'] = gibbs_acc_err(xt, n, ILR, 1, labels, gacc)
    m = cuda_estep.feature_width(ILR, d, 1)
    fed_rows(card, name, [
        ('B1-fed-ilr16', lambda: cuda_estep.estep(xt, th_vi, n, ILR, 1),
         lambda: cuda_estep.estep_plain(xt, th_vi, n, ILR, 1),
         estep_work(n, k, m, d + 1), f'{name}, VI theta'),
        ('B2-fed-ilr16',
         lambda: cuda_gibbs.gibbs(xt, th_g, sweep_seed, n, ILR, 1),
         lambda: cuda_gibbs.gibbs_plain(xt, th_g, sweep_seed, n, ILR, 1),
         gibbs_work(xt, th_g, n, m, ILR, 1), f'{name}, plug-in theta')],
        ms)
    del x, y, xt, model, st, gs
    torch.cuda.empty_cache()


def fed_paths(dev, seed, card, errs, launches, ms):
    """Phase 27 (the docstring at the top)."""
    for cell in FED_CELLS:
        fed_gmm_cell(dev, seed, card, errs, launches, ms, cell)
    fed_ilr_cell(dev, seed, card, errs, launches, ms)


if __name__ == '__main__':
    main()
