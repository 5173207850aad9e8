"""Counter-based Philox4x32-10 and the Gumbel-max label draw, in plain
PyTorch integer arithmetic.

This is the generator that kernel B2 (csrc/gibbs.cuh) runs on the card:
the draws for point n and component k depend only on (seed, n, k), so
the plain version and the kernel give the same labels whatever their
blocking. 32-bit words live in int64 tensors; the 32x32 -> 64-bit
products are split into 16-bit halves so nothing overflows int64.
"""

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57        # round multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85        # key bumps (Weyl sequence)
_MASK = 0xFFFFFFFF
_KNUTH = 0x9E3779B9                      # the shard offset of sweep seeds


def _mulhilo(a, m):
    """(hi, lo) 32-bit words of a * m, a in [0, 2^32) as int64, m < 2^32."""
    t1 = (a >> 16) * m                    # < 2^48
    t0 = (a & 0xFFFF) * m                 # < 2^48
    hi = (t1 + (t0 >> 16)) >> 16
    lo = (((t1 & 0xFFFF) << 16) + t0) & _MASK
    return hi, lo


def philox4x32_10(ctr, key):
    """Philox4x32 with 10 rounds (Random123). ctr: four int64 tensors (or
    ints) of 32-bit words; key: two. Returns the four output words."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK
            k1 = (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniforms(seed, start, b, k, dtype):
    """(b, k) uniforms u = (bits >> 9) 2^-23 for points start..start+b-1:
    component k of point n is word k % 4 of Philox(ctr=(n_lo, n_hi, k // 4,
    0), key=(seed_lo, seed_hi)). `seed` is an int64 tensor (0-d) on the
    target device, so no host sync is needed."""
    dev = seed.device
    idx = start + torch.arange(b, dtype=torch.int64, device=dev)[:, None]
    grp = torch.arange(-(-k // 4), dtype=torch.int64, device=dev)[None, :]
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    key = (seed & _MASK, (seed >> 32) & _MASK)
    words = philox4x32_10((idx & _MASK, (idx >> 32) & _MASK, grp, zero), key)
    bits = torch.stack(torch.broadcast_tensors(*words), -1).reshape(b, -1)
    return (bits[:, :k] >> 9).to(dtype) * 2.0 ** -23


def gumbel_max_labels(logp, seed, start):
    """First-occurrence argmax over K of logp + Gumbel noise
    g = -log(-log(u + 1e-20) + 1e-20), for the (B, K) block of points
    start..start+B-1. Returns int32 labels (B,). For C chains, logp
    (C, B, K) and seeds (C,): chain c draws with seed[c], labels (C, B)."""
    if logp.dim() == 3:
        return torch.stack([gumbel_max_labels(lp, sd, start)
                            for lp, sd in zip(logp, seed.reshape(-1))])
    b, k = logp.shape
    u = uniforms(seed, start, b, k, logp.dtype)
    g = -torch.log(-torch.log(u + 1e-20) + 1e-20)
    return torch.argmax(logp + g, dim=-1).to(torch.int32)


def shard_seed(seed, j):
    """Data shard j's sweep seed on a mesh: the sweep seed XOR
    j 0x9E3779B9, in the seeds' int64 (the form of mimo_tpu's per-device
    seed, pallas_gibbs.py:266-267). Shard 0 keeps the sweep seed, so it
    draws the unsharded sweep's Philox numbers on its points."""
    return torch.bitwise_xor(seed, j * _KNUTH)
