"""The one generator of traffic: it reads a mix's parameters
(traffic/<name>.json) and drives the port, through the cell's model
adapter (adapters/<model>.py), with them. Two kinds:

  fit    whole calls of a fit engine back to back: `engine`, `chains`,
         `maxiter`; `start` "anchor" starts every call from the chains'
         set-up posteriors (the adapter's start, randomize=False), null
         from the engine's own start; `keys` "fixed" gives every call
         the same chain keys, "fresh" new ones a call (from the seed). A
         call's work is N x chains x maxiter points.
  serve  one caller in a closed loop: requests back to back, each timed
         from its call to its synchronised result; a request is the
         adapter's serving call (with the mix's parameters, such as
         `dist`) over n points, a slice of a pool of 2^pool_log2 points
         the adapter draws like the fit data; the sizes are `sizes`
         values of log2 n stratified over `log2_n`. Every seed asks for
         the same sizes in its own order. The posterior is a `posterior`
         fit made in set-up from the adapter's start.

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

    def __init__(self, cell, adapter, model, data, seed, device):
        t = cell.traffic
        self.adapter, self.model, self.data = adapter, model, data
        self.config, self.seed, self.device = cell.config, seed, device
        self.engine, self.chains = t['engine'], int(t['chains'])
        self.maxiter, self.keys_mode = int(t['maxiter']), t['keys']
        self.start = (adapter.start(cell.config, data, self.chains, seed)
                      if t.get('start') == 'anchor' else None)
        self.n = self.adapter.shape(model, data)['n']
        self.sampler = Sampler(t['sample'], gen.host_rng(seed, 'sample'))

    def keys(self, i):
        tag = ('fixed',) if self.keys_mode == 'fixed' else ('call', i)
        return [gen.sub_seed(self.seed, 'keys', *tag, c) % 2 ** 62
                for c in range(self.chains)]

    def warm(self):
        self.call(-1)

    def call(self, i):
        return self.adapter.fit(self.model, self.engine, self.data,
                                self.keys(i), self.maxiter, self.start)

    def points(self, _i):
        return self.n * self.chains * self.maxiter

    def units(self, _i):
        """Sweeps a call runs (each over every chain)."""
        return self.maxiter

    def shape(self):
        return dict(self.adapter.shape(self.model, self.data),
                    chains=self.chains)

    def record(self, i, out):
        self.sampler.offer(0, dict(call=i, out=out))

    def numbers(self, control, g):
        """The compared numbers of the kept calls; with `control`, of the
        control's outputs in their place."""
        outs = [k['out'] for k in self.sampler.kept()]
        if control:
            outs = self.adapter.control_fit(self.config, self.engine,
                                            self.data, self.start, outs,
                                            self.maxiter, g)
        return self.adapter.numbers_fit(self.config, self.engine, self.data,
                                        self.start, outs)


class Serve:
    span = 'portbench.serve_request'

    def __init__(self, cell, adapter, model, data, seed, device):
        t = cell.traffic
        self.adapter, self.model, self.data = adapter, model, data
        self.config, self.seed, self.device = cell.config, seed, device
        self.traffic = t
        self.pool = adapter.pool(cell.config, seed, 2 ** int(t['pool_log2']),
                                 device)
        post = t['posterior']
        self.start = adapter.start(cell.config, data, 1, seed)
        self.fit_engine = post['engine']
        self.fit_maxiter = int(post['maxiter'])
        fit = adapter.fit(model, self.fit_engine, data,
                          [gen.sub_seed(seed, 'posterior') % 2 ** 62],
                          self.fit_maxiter, self.start)
        self.fit_out = fit
        self.posterior = {k: v[0] for k, v in fit.items() if k != 'trace'}
        self.state = adapter.state(model, fit, 0)
        self.plan = gen.request_plan(t, adapter.shape(model, self.pool)['n'],
                                     seed)
        self.requests = []
        self.sampler = Sampler(t['sample'], gen.host_rng(seed, 'sample'),
                               keep_largest=True)

    def warm(self):
        """Every request size once, largest first."""
        for n in sorted(gen.request_sizes(self.traffic), reverse=True):
            self.adapter.serve(self.model, self.state, self.pool, 0, n,
                               self.traffic)

    def request(self, i):
        """(offset, n) of request i."""
        while len(self.requests) <= i:
            self.requests.append(next(self.plan))
        return self.requests[i]

    def call(self, i):
        off, n = self.request(i)
        return self.adapter.serve(self.model, self.state, self.pool, off, n,
                                  self.traffic)

    def points(self, i):
        return self.request(i)[1]

    def units(self, _i):
        return 1

    def shape(self):
        """The pool's shape; the work count takes each request's n."""
        return self.adapter.shape(self.model, self.pool)

    def record(self, i, out):
        off, n = self.request(i)
        self.sampler.offer(n, dict(call=i, offset=off, n=n, out=out))

    def numbers(self, control, g):
        """The compared numbers of the kept requests, and of the set-up
        fit that made the posterior (prefixed `fit_`); with `control`, of
        the control's outputs in their place."""
        outs, fit = self.sampler.kept(), [self.fit_out]
        if control:
            outs = self.adapter.control_serve(self.config, self.pool,
                                              self.posterior, outs, g)
            fit = self.adapter.control_fit(self.config, self.fit_engine,
                                           self.data, self.start, fit,
                                           self.fit_maxiter, g)
        found = self.adapter.numbers_serve(self.config, self.pool,
                                           self.posterior, outs)
        for name, value in self.adapter.numbers_fit(
                self.config, self.fit_engine, self.data, self.start,
                fit).items():
            found['fit_' + name] = value
        return found


KINDS = {'fit': Fit, 'serve': Serve}


def driver(cell, adapter, model, data, seed, device):
    """The traffic's driver of `model` (the adapter's make) over the fit
    data, its set-up done (starts, the serving pool and posterior)."""
    kind = cell.traffic['kind']
    if kind not in KINDS:
        raise ValueError(f'unknown traffic kind {kind!r}; one of '
                         f'{sorted(KINDS)}')
    return KINDS[kind](cell, adapter, model, data, seed, device)


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
