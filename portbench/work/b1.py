"""B1, the fused mixture E-step of mean-field VI: per sweep, a logits
pass and a statistics pass over N points, K components and C chains on
the Gaussian statistics [1, x, vec(x x^T)], m = 1 + d + d^2 of them.
The algorithm's work, not the kernel's: no padding, no extra passes."""

# the device kernels a B1 launch runs (matched by re.search on the
# profiler's kernel names)
KERNELS = (r'\b(estep_tc|estep_st_logits|estep_st_stats|finish_lse'
           r'|st_prep|reduce_partials)\b')


def features(d):
    return 1 + d + d * d


def count(shape):
    """(MACs, bytes) of one sweep: 2 C N K m products; x and theta read
    once, the statistics and the log-normalisers written once, in
    float32."""
    n, d, k = shape['n'], shape['d'], shape['k']
    c, m = shape.get('chains', 1), features(d)
    macs = 2 * c * n * k * m
    nbytes = 4 * (n * d + 2 * c * k * m + c)
    return macs, nbytes
