"""The one generator of traffic: it reads a mix's parameters
(traffic/<name>.json) and drives the port with them. Two kinds:

  fit    whole calls of a fit engine back to back: `engine`, `chains`,
         `maxiter`; `start` "anchor" starts every call from the chains'
         set-up posteriors (gen.anchor_start, randomize=False), null from
         the engine's own start; `keys` "fixed" gives every call the same
         chain keys, "fresh" new ones a call (from the seed). A call's
         work is N x chains x maxiter points.
  serve  one caller in a closed loop: requests back to back, each timed
         from its call to its synchronised result; a request is
         log_predictive (`dist`) of n points, a slice of a pool of
         2^pool_log2 points drawn from the configuration's blobs; the
         sizes are `sizes` values of log2 n stratified over `log2_n`.
         Every seed asks for the same sizes in its own order. The
         posterior is a `posterior` fit made in set-up.

`kernel` names the work count (work/<kernel>.py) of the calls' per-point
pass, `sample` how many outputs the check keeps ("all", or that many
drawn from the seed by reservoir sampling; a serve cell also keeps its
largest request)."""

import contextlib
import time

import torch

from harness import gen


class Sampler:
    """A seeded reservoir of the window's outputs."""

    def __init__(self, size, rng, keep_largest=False):
        self.size, self.rng = size, rng
        self.items, self.seen = [], 0
        self.keep_largest, self.largest = keep_largest, None

    def offer(self, weight, item):
        if self.keep_largest and (self.largest is None
                                  or weight > self.largest[0]):
            self.largest = (weight, item)
        if self.size == 'all' or len(self.items) < self.size:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.size:
                self.items[j] = item
        self.seen += 1

    def kept(self):
        out = list(self.items)
        if self.largest is not None and all(self.largest[1] is not it
                                            for it in out):
            out.append(self.largest[1])
        return out


class Fit:
    span = 'portbench.fit_call'

    def __init__(self, cell, port, x, seed):
        t = cell.traffic
        self.port, self.x, self.seed = port, x, seed
        self.engine, self.chains = t['engine'], int(t['chains'])
        self.maxiter, self.keys_mode = int(t['maxiter']), t['keys']
        self.start = (gen.anchor_start(cell.config, x, self.chains, seed)
                      if t.get('start') == 'anchor' else None)
        self.sampler = Sampler(t['sample'], gen.host_rng(seed, 'sample'))

    def keys(self, i):
        tag = ('fixed',) if self.keys_mode == 'fixed' else ('call', i)
        return [gen.sub_seed(self.seed, 'keys', *tag, c) % 2 ** 62
                for c in range(self.chains)]

    def warm(self):
        self.call(-1)

    def call(self, i):
        return self.port.fit(self.engine, self.x, self.keys(i), self.maxiter,
                             self.start)

    def points(self, _i):
        return self.x.shape[0] * self.chains * self.maxiter

    def units(self, _i):
        """Sweeps a call runs (each over every chain)."""
        return self.maxiter

    def shape(self):
        n, d = self.x.shape
        return dict(n=n, d=d, k=self.port.model.size, chains=self.chains)

    def record(self, i, out):
        self.sampler.offer(0, dict(call=i, out=out))


class Serve:
    span = 'portbench.serve_request'

    def __init__(self, cell, port, x, seed):
        t = cell.traffic
        self.port, self.seed, self.dist, self.traffic = (port, seed,
                                                         t['dist'], t)
        data, d = cell.config['data'], cell.config['make']['dim']
        means = gen.blob_means(data, d, seed, x.device)
        self.pool = gen.blob_points(data, means, 2 ** int(t['pool_log2']),
                                    gen.generator(seed, x.device, 'pool'))
        post = t['posterior']
        self.start = gen.anchor_start(cell.config, x, 1, seed)
        fit = port.fit(post['engine'], x, [gen.sub_seed(seed, 'posterior')
                                           % 2 ** 62], int(post['maxiter']),
                       self.start)
        self.fit_out, self.fit_maxiter = fit, int(post['maxiter'])
        self.posterior = {k: v[0] for k, v in fit.items() if k != 'trace'}
        self.state = port.state(fit, 0)
        self.plan = gen.request_plan(t, self.pool.shape[0], seed)
        self.requests = []
        self.sampler = Sampler(t['sample'], gen.host_rng(seed, 'sample'),
                               keep_largest=True)

    def warm(self):
        """Every request size once, largest first."""
        for n in sorted(gen.request_sizes(self.traffic), reverse=True):
            self.port.serve(self.state, self.pool[:n], self.dist)

    def request(self, i):
        """(offset, n) of request i."""
        while len(self.requests) <= i:
            self.requests.append(next(self.plan))
        return self.requests[i]

    def call(self, i):
        off, n = self.request(i)
        return self.port.serve(self.state, self.pool[off:off + n], self.dist)

    def points(self, i):
        return self.request(i)[1]

    def units(self, _i):
        return 1

    def shape(self):
        return dict(d=self.pool.shape[1], k=self.port.model.size)

    def record(self, i, out):
        off, n = self.request(i)
        self.sampler.offer(n, dict(call=i, offset=off, n=n, out=out))


KINDS = {'fit': Fit, 'serve': Serve}


def driver(cell, port, x, seed):
    kind = cell.traffic['kind']
    if kind not in KINDS:
        raise ValueError(f'unknown traffic kind {kind!r}; one of '
                         f'{sorted(KINDS)}')
    return KINDS[kind](cell, port, x, seed)


class Window:
    """The calls of one measured stretch: elapsed seconds, calls, points,
    per-call latencies (s), units (sweeps or requests) and the index of
    the first call."""

    def __init__(self):
        self.elapsed, self.calls, self.points, self.units = 0.0, 0, 0, 0
        self.latencies, self.first = [], None


def run(drv, seconds, sync, first=0, min_calls=1, keep=True, spans=False):
    """Calls from index `first`, back to back, until `seconds` have passed
    (and at least `min_calls` ran); the window ends at the first call
    boundary after that. With `spans` each call is a profiler range named
    by the driver's `span`; `keep` offers each output to the driver's
    sampler."""
    from torch.profiler import record_function
    w = Window()
    w.first = first
    sync()
    t0 = time.perf_counter()
    i = first
    while True:
        ts = time.perf_counter()
        with (record_function(drv.span) if spans
              else contextlib.nullcontext()):
            out = drv.call(i)
        sync()
        te = time.perf_counter()
        w.latencies.append(te - ts)
        w.points += drv.points(i)
        w.units += drv.units(i)
        if keep:
            drv.record(i, out)
        del out
        i += 1
        if te - t0 >= seconds and i - first >= min_calls:
            break
    w.elapsed, w.calls = te - t0, i - first
    return w


def synchronizer(device):
    if device.type == 'cuda':
        return lambda: torch.cuda.synchronize(device)
    return lambda: None
