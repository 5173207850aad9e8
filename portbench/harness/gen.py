"""Inputs made from the seed, on the device: the configuration's data, the
fits' starting posteriors, the serving pool and the order of request
sizes. The same seed gives the same inputs; each kind of draw has a
stream of its own, so a cell's traffic never shifts another's data."""

import hashlib
import math
import random

import torch

from reference import dpgmm


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


def blob_means(data, d, seed, device):
    """The blobs' means, N(0, I) * mean_scale: drawn from the run's seed,
    or, where the configuration fixes `means_seed`, from that seed on the
    host, the same on every device and in every run."""
    shape = (len(data['weights']), d)
    if 'means_seed' in data:
        g = torch.Generator().manual_seed(sub_seed(data['means_seed'],
                                                   'means'))
        means = torch.randn(shape, generator=g).to(device)
    else:
        means = torch.randn(shape, generator=generator(seed, device,
                                                       'means'),
                            device=device)
    return means * float(data['mean_scale'])


def blob_points(data, means, n, gen):
    """n points of the blob mixture: label by the weights, then the blob's
    mean plus N(0, I / precision) noise, float32."""
    w = torch.tensor(data['weights'], dtype=torch.float32,
                     device=means.device)
    labels = torch.multinomial(w, n, replacement=True, generator=gen)
    noise = torch.randn((n, means.shape[1]), generator=gen,
                        device=means.device)
    return means[labels] + noise / math.sqrt(float(data['precision']))


def dataset(config, seed, device):
    """The configuration's fit data (N, d) float32 and its blob means."""
    data, d = config['data'], config['make']['dim']
    means = blob_means(data, d, seed, device)
    return blob_points(data, means, int(data['n']),
                       generator(seed, device, 'data')), means


def anchor_start(config, x, chains, seed, sub=65536):
    """Each chain's starting posterior, float32 (C, K, ...): a subsample of
    `sub` points assigned to the nearest of K of them, its statistics
    scaled to the N points and taken through the conjugate update in
    float64 (the reference's). A fit from here starts with the components
    apart, as a warm restart does."""
    make = config['make']
    k, (n, d) = make['size'], x.shape
    prior = dpgmm.make_prior(make, d, torch.float64, x.device)
    g = generator(seed, x.device, 'start')
    stats = []
    for _ in range(chains):
        pts = x[torch.randint(0, n, (sub,), generator=g,
                              device=x.device)].double()
        z = torch.argmin(torch.cdist(pts, pts[:k]), 1)
        resp = torch.nn.functional.one_hot(z, k).double()[:, None, :]
        stats.append([s[0] * (n / sub)
                      for s in dpgmm.stats_from_resp(pts, resp)])
    counts, sx, sxx = (torch.stack(s) for s in zip(*stats))
    return dpgmm.cast(dpgmm.posterior(prior, counts, sx, sxx), torch.float32)


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
