"""B2, the fused Gibbs label sweep: per sweep, the plug-in logits of N
points over K components for C chains on the Gaussian statistics
[1, x, vec(x x^T)], m = 1 + d + d^2, a label drawn a point and chain,
and the labels' one-hot statistics (no products: a label picks its
row). The algorithm's work, not the kernel's: no padding, no random
number generator."""

KERNELS = (r'\b(gibbs_tc|gibbs_st_logits|gibbs_st_stats|st_prep'
           r'|reduce_partials)\b')


def features(d):
    return 1 + d + d * d


def count(shape):
    """(MACs, bytes) of one sweep: C N K m products; x and theta read
    once, the statistics and the C N int32 labels written once."""
    n, d, k = shape['n'], shape['d'], shape['k']
    c, m = shape.get('chains', 1), features(d)
    macs = c * n * k * m
    nbytes = 4 * (n * d + 2 * c * k * m + c * n)
    return macs, nbytes
