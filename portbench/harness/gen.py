"""The seed's streams, and the order of request sizes. The same seed
gives the same inputs; each kind of draw (the model adapter's data,
starts and serving pool, the keys, the requests) has a stream of its own,
named, so a cell's traffic never shifts another's data."""

import hashlib
import random

import torch


def sub_seed(seed, *names):
    """A 63-bit seed for the stream `names` of run seed `seed` (any whole
    number)."""
    text = '/'.join([str(int(seed))] + [str(n) for n in names])
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          'little') & (2 ** 63 - 1)


def generator(seed, device, *names):
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *names))


def host_rng(seed, *names):
    return random.Random(sub_seed(seed, *names))


def request_sizes(traffic):
    """The fixed multiset of serving request sizes: `sizes` points of
    log2 n stratified over [lo, hi]."""
    lo, hi = traffic['log2_n']
    count = int(traffic['sizes'])
    return [int(round(2.0 ** (lo + (hi - lo) * (i + 0.5) / count)))
            for i in range(count)]


def request_plan(traffic, pool_n, seed):
    """An endless sequence of (offset, n): each pass gives every size once,
    in an order drawn from the seed, so that every seed asks for the same
    work; the offset in the pool is drawn from the seed."""
    rng = host_rng(seed, 'requests')
    sizes = request_sizes(traffic)
    while True:
        order = sizes[:]
        rng.shuffle(order)
        for n in order:
            yield rng.randrange(0, pool_n - n + 1), n
