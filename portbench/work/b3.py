"""B3, the posterior-predictive serving kernel: the Student-t (or
Gaussian) quadratic form of N points against K components on
[1, x, vec(x x^T)], m = 1 + d + d^2, then a log-sum-exp over K. The
algorithm's work, not the kernel's: no padding, no exponentials or logs
counted as a term of their own."""

KERNELS = r'\b(predict_kernel|predict_wide_kernel)\b'


def features(d):
    return 1 + d + d * d


def count(shape):
    """(MACs, bytes) of one request of n points: N K m products; x and
    the K rows of coefficients read once, N densities written once."""
    n, d, k = shape['n'], shape['d'], shape['k']
    m = features(d)
    return n * k * m, 4 * (n * d + k * m + n)
