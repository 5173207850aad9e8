"""The precision rule of kernels B1 and B2 (csrc/estep.cuh) emulated on
float32 tensors, and the fixed-state two-sample check of B2 that holds its
draws to the rule's softmax. Neither runs in a fit: tests and chip_smoke.py
use them to check the kernels.

The rule: TF32 rounding (cvt.rna.tf32.f32: round to nearest, ties away
from zero, 10 mantissa bits kept), the exact three-part splits of theta
and F for the logits (six passes), and the two-part splits of P and F for
the statistics (three passes). Products of tf32 parts are exact in f32,
their sums are f32.

The two-sample check (the counterpart of scripts/gibbs_twosample.py, the
first half of ROADMAP A10): from ONE fixed plug-in state theta (K, m8), S
independent label sweeps are S chains of that theta with distinct seeds,
drawn in one B2 launch (ops/cuda_gibbs.py; the plain version on CPU
tensors). Given the state the labels are independent, so each
component's count is a sum of independent Bernoullis:

    E[count_k] = sum_n p_nk,   Var[count_k] = sum_n p_nk (1 - p_nk)

with p = softmax over K of the logits. The S count vectors are compared,
over the live components (E > 5), with the exact float64 expectation and
with the expectation under the rule's logits: per-component z of the mean
count, chi^2 / df, and the empirical-to-Bernoulli variance ratio.
"""

import torch

from mimo_tpu_torch.ops import cuda_gibbs
from mimo_tpu_torch.ops.cuda_estep import GAUSS, assemble_features

# a sampler that draws the softmax passes these (S >= 64)
MAX_Z, MAX_CHI2_DF, VAR_RATIO = 5.0, 2.0, (0.8, 1.25)
MIN_EXPECTED = 5.0          # live components: expected count above this

# the product terms of the logits, (theta part, F part), 0 = hi: the rule's
# six, down to 2^-22 relative
RULE = ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0))


def tf32(x):
    """cvt.rna.tf32.f32 on a float32 tensor: add half of the 13 dropped
    bits to the magnitude bits, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split2(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def split3(x):
    """x = hi + mid + lo exactly (an f32 has 24 significant bits)."""
    hi = tf32(x)
    mid = tf32(x - hi)
    return hi, mid, (x - hi) - mid


def emulated_logits(xt, theta, n, kind=GAUSS, p=0, terms=RULE,
                    split_f=True):
    """The logits theta F (K, n) under the rule, or with the terms given;
    without split_f, F as its tf32 part and the remainder's tf32
    rounding."""
    f = assemble_features(xt[:, :n], theta.shape[1], kind, p)
    th, fs = split3(theta), split3(f)
    if not split_f:
        fs = (fs[0], tf32(f - fs[0]), torch.zeros_like(f))
    return sum(th[a] @ fs[b] for a, b in terms[:-1]) + th[0] @ fs[0]


def emulated_estep(xt, theta, n, kind=GAUSS, p=0, terms=RULE, split_p=True,
                   split_f=True):
    """B1 under the rule, or with the terms or splits given. Returns
    (acc (K, m8), lse (), logits (K, n))."""
    logits = emulated_logits(xt, theta, n, kind, p, terms, split_f)
    mx = logits.max(0, keepdim=True).values
    ex = torch.exp(logits - mx)
    den = ex.sum(0, keepdim=True).clamp(min=1e-37)
    r = ex * (1.0 / den)
    fh, fl = split2(assemble_features(xt[:, :n], theta.shape[1], kind, p))
    if split_p:
        rh, rl = split2(r)
        acc = rl @ fh.T + rh @ fl.T + rh @ fh.T
    else:
        acc = tf32(r) @ fl.T + tf32(r) @ fh.T
    return acc, (mx + torch.log(den)).sum(), logits


# -- the fixed-state two-sample check of B2 -----------------------------------

def count_moments(logits):
    """(E, Var) of the per-component counts (K,) in float64 from the
    logits (K, n)."""
    prob = torch.softmax(logits.double(), 0)
    return prob.sum(1), (prob * (1.0 - prob)).sum(1)


def chain_counts(labels, k):
    """(S, K) float64 label counts of S chains' labels (S, n)."""
    counts = torch.zeros((labels.shape[0], k), dtype=torch.float64,
                         device=labels.device)
    return counts.scatter_add_(1, labels.long(),
                               torch.ones_like(labels, dtype=torch.float64))


def count_stats(counts, expect, var):
    """max |z|, chi^2 / df and the variance ratio of S count vectors (S, K)
    against an expectation, over the components with expect > 5."""
    s = counts.shape[0]
    live = expect > MIN_EXPECTED
    z = (counts.mean(0) - expect) / torch.sqrt(var.clamp(min=1e-12) / s)
    ratio = counts.var(0) / var.clamp(min=1e-12)
    return {'live': int(live.sum()), 'max_z': float(z[live].abs().max()),
            'chi2_df': float((z[live] ** 2).mean()),
            'var_ratio': float(ratio[live].mean())}


def passes(stats):
    return (stats['max_z'] <= MAX_Z and stats['chi2_df'] <= MAX_CHI2_DF
            and VAR_RATIO[0] <= stats['var_ratio'] <= VAR_RATIO[1])


def fixed_state_check(xt, theta, seeds, n, kind=GAUSS, p=0):
    """S = len(seeds) label sweeps of one theta (K, m8) over points
    0..n-1 of xt, as S chains of B2 in one launch (the plain version on
    CPU tensors). Returns ({'exact': count_stats, 'emulated':
    count_stats}, the labels (S, n))."""
    s = seeds.shape[0]
    labels, _ = cuda_gibbs.gibbs(
        xt, theta.expand((s,) + theta.shape).contiguous(), seeds, n, kind, p)
    counts = chain_counts(labels, theta.shape[0])
    f64 = assemble_features(xt[:, :n].double(), theta.shape[1], kind, p)
    exact = count_moments(theta.double() @ f64)
    emulated = count_moments(emulated_logits(xt, theta, n, kind, p))
    return ({'exact': count_stats(counts, *exact),
             'emulated': count_stats(counts, *emulated)}, labels)
