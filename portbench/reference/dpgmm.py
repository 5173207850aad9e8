"""Plain PyTorch reference of the stick-breaking Normal-Wishart DP-GMM.

Written from the model's equations, for the benchmark to judge the
port's outputs with. It imports nothing but torch: no kernel, no part of
the measured package. Every function works on any device and in any
dtype, batched over a leading chain axis C.

Model, per component k of K:
    Lambda_k ~ W(psi_k, nu_k)  (E[Lambda] = nu psi),
    mu_k | Lambda_k ~ N(m_k, (kappa_k Lambda_k)^-1),
    x | z = k ~ N(mu_k, Lambda_k^-1);
weights by stick-breaking, v_k ~ Beta(gamma_k, delta_k),
pi_k = v_k prod_{j<k} (1 - v_j). As the measured package defines the
truncation, every stick keeps its Beta in E[log pi] and in the KL, and
the predictive weights E[pi] force the last stick to 1.

A posterior is a dict of tensors: mu (C, K, d), kappa (C, K),
psi (C, K, d, d), nu (C, K), gamma (C, K), delta (C, K). A prior is the
same dict without the chain and component axes, plus alpha.

`mode` selects the arithmetic: 'f64' is the reference (float64
throughout); 'tf32' is the control, float32 with the two per-point
products (the logits and the statistics, or the predictive's quadratic
form) taken on operands rounded to TF32, as one pass of a TF32 tensor
core would take them.
"""

import math

import torch

from reference.precision import matmul

LOG2PI = math.log(2.0 * math.pi)
BLOCK_BYTES = 1 << 30      # about this many bytes an intermediate array


def dtype_of(mode):
    if mode not in ('f64', 'tf32'):
        raise ValueError(f'unknown mode {mode!r}')
    return torch.float64 if mode == 'f64' else torch.float32


def block_rows(width, itemsize=8):
    """Points a block so that a (rows, width) array takes ~BLOCK_BYTES."""
    return max(1024, BLOCK_BYTES // (itemsize * max(width, 1)))


def make_prior(make, d, dtype, device):
    """The prior of BayesianGMM.make(gating='dp', alpha, kappa, psi_scale)
    with the default mean 0 and nu = d + 2."""
    return dict(mu=torch.zeros(d, dtype=dtype, device=device),
                kappa=torch.tensor(float(make['kappa']), dtype=dtype,
                                   device=device),
                psi=float(make['psi_scale']) * torch.eye(d, dtype=dtype,
                                                         device=device),
                nu=torch.tensor(float(make.get('nu') or d + 2), dtype=dtype,
                                device=device),
                alpha=torch.tensor(float(make['alpha']), dtype=dtype,
                                   device=device))


def cast(tree, dtype):
    return {k: v.to(dtype) for k, v in tree.items()}


def features(x):
    """The Gaussian statistics [1, x, vec(x x^T)] of points x (B, d)."""
    b, d = x.shape
    return torch.cat([x.new_ones((b, 1)), x,
                      (x[:, :, None] * x[:, None, :]).reshape(b, d * d)], 1)


# -- conjugate updates ---------------------------------------------------------

def niw_update(prior, counts, sx, sxx):
    """Normal-Wishart posterior from weighted statistics: counts (C, K),
    sx (C, K, d), sxx (C, K, d, d). The scale in its centred form,
    psi'^-1 = psi^-1 + (S - n xbar xbar^T) + kappa n / kappa'
    (xbar - m)(xbar - m)^T, so that float32 (the control) does not
    cancel kappa m m^T against kappa' m' m'^T."""
    kappa = prior['kappa'] + counts
    mu = (prior['kappa'] * prior['mu'] + sx) / kappa[..., None]
    xbar = sx / counts.clamp(min=1e-12)[..., None]
    dm = xbar - prior['mu']
    psi_inv = (torch.linalg.inv(prior['psi'])
               + sxx - counts[..., None, None] * xbar[..., :, None]
               * xbar[..., None, :]
               + (prior['kappa'] * counts / kappa)[..., None, None]
               * dm[..., :, None] * dm[..., None, :])
    psi_inv = 0.5 * (psi_inv + psi_inv.transpose(-1, -2))
    return dict(mu=mu, kappa=kappa, psi=torch.linalg.inv(psi_inv),
                nu=prior['nu'] + counts)


def sb_update(prior, counts):
    """Stick-breaking posterior: gamma = 1 + N_k, delta = alpha + N_{>k}."""
    after = torch.flip(torch.cumsum(torch.flip(counts, (-1,)), -1), (-1,))
    return dict(gamma=1.0 + counts,
                delta=prior['alpha'] + torch.clamp(after - counts, min=0.0))


def posterior(prior, counts, sx, sxx):
    return {**niw_update(prior, counts, sx, sxx), **sb_update(prior, counts)}


def natural_update(prior, counts, sx, sxx):
    """The posterior as `natural` gives it, straight from the statistics:
    no inverse, so it exists where the scale is not positive definite."""
    m0 = prior['mu']
    return dict(kmu=prior['kappa'] * m0 + sx, kappa=prior['kappa'] + counts,
                scatter=torch.linalg.inv(prior['psi'])
                + prior['kappa'] * m0[:, None] * m0[None, :] + sxx,
                nu=prior['nu'] + counts, **sb_update(prior, counts))


def stats_from_resp(x, resp):
    """counts, sx, sxx from x (B, d) and responsibilities (B, C, K)."""
    return (resp.sum(0), torch.einsum('bck,bd->ckd', resp, x),
            torch.einsum('bck,bd,be->ckde', resp, x, x))


def stats_from_labels(x, labels, k, mode='f64'):
    """One-hot statistics of integer labels (C, N) over points x (N, d)."""
    dt = dtype_of(mode)
    c, n = labels.shape
    d = x.shape[1]
    counts = x.new_zeros((c, k), dtype=dt)
    sx = x.new_zeros((c, k, d), dtype=dt)
    sxx = x.new_zeros((c, k, d, d), dtype=dt)
    rows = block_rows(d * d)
    for lo in range(0, n, rows):
        xb = x[lo:lo + rows].to(dt)
        f = (xb[:, :, None] * xb[:, None, :]).reshape(-1, d * d)
        for ci in range(c):
            z = labels[ci, lo:lo + rows].long()
            counts[ci].index_add_(0, z, torch.ones_like(xb[:, 0]))
            sx[ci].index_add_(0, z, xb)
            sxx[ci].view(k, d * d).index_add_(0, z, f)
    return counts, sx, sxx


# -- expectations and divergences ---------------------------------------------

def mvdigamma(a, d):
    return sum(torch.digamma(a - 0.5 * i) for i in range(d))


def mvlgamma(a, d):
    return (0.25 * d * (d - 1) * math.log(math.pi)
            + sum(torch.lgamma(a - 0.5 * i) for i in range(d)))


def logdet(a):
    return 2.0 * torch.log(torch.diagonal(torch.linalg.cholesky(a),
                                          dim1=-2, dim2=-1)).sum(-1)


def e_logdet(post):
    d = post['mu'].shape[-1]
    return (mvdigamma(0.5 * post['nu'], d) + d * math.log(2.0)
            + logdet(post['psi']))


def niw_log_partition(p):
    d = p['mu'].shape[-1]
    return (-0.5 * d * torch.log(p['kappa'])
            + 0.5 * p['nu'] * d * math.log(2.0)
            + mvlgamma(0.5 * p['nu'], d) + 0.5 * p['nu'] * logdet(p['psi']))


def niw_kl(q, prior):
    """KL(q || prior) of each component (C, K): logZ(p) - logZ(q) +
    <eta_q - eta_p, E_q t>, eta = [kappa m, kappa, psi^-1 + kappa m m^T,
    nu - d], t = [Lambda mu, -mu^T Lambda mu / 2, -Lambda / 2,
    logdet(Lambda) / 2]."""
    d = q['mu'].shape[-1]
    p = {k: prior[k].expand(q[k].shape) for k in ('mu', 'kappa', 'psi',
                                                   'nu')}
    psi_m = torch.einsum('...de,...e->...d', q['psi'], q['mu'])
    e_lm = q['nu'][..., None] * psi_m
    e_mlm = -0.5 * (d / q['kappa'] + q['nu'] * (q['mu'] * psi_m).sum(-1))
    e_l = -0.5 * q['nu'][..., None, None] * q['psi']

    def eta(a):
        outer = a['mu'][..., :, None] * a['mu'][..., None, :]
        return (a['kappa'][..., None] * a['mu'], a['kappa'],
                torch.linalg.inv(a['psi'])
                + a['kappa'][..., None, None] * outer, a['nu'] - d)

    (aq, bq, cq, dq), (ap, bp, cp, dp) = eta(q), eta(p)
    inner = (((aq - ap) * e_lm).sum(-1) + (bq - bp) * e_mlm
             + ((cq - cp) * e_l).sum((-1, -2))
             + (dq - dp) * 0.5 * e_logdet(q))
    return niw_log_partition(p) - niw_log_partition(q) + inner


def e_log_sticks(post):
    both = torch.digamma(post['gamma'] + post['delta'])
    return (torch.digamma(post['gamma']) - both,
            torch.digamma(post['delta']) - both)


def e_log_pi(post):
    e_v, e_rest = e_log_sticks(post)
    return e_v + torch.cumsum(e_rest, -1) - e_rest


def betaln(a, b):
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


def sb_kl(q, prior):
    """KL(Beta(gamma, delta) || Beta(1, alpha)) summed over the sticks."""
    one = torch.ones_like(q['gamma'])
    alpha = prior['alpha'] * one
    e_v, e_rest = e_log_sticks(q)
    return (betaln(one, alpha) - betaln(q['gamma'], q['delta'])
            + (q['gamma'] - 1.0) * e_v
            + (q['delta'] - alpha) * e_rest).sum(-1)


def sb_mean(post):
    """E[pi] with the last stick forced to 1."""
    v = post['gamma'] / (post['gamma'] + post['delta'])
    v = torch.cat([v[..., :-1], torch.ones_like(v[..., -1:])], -1)
    rest = torch.log1p(-v[..., :-1])
    lead = torch.cat([torch.zeros_like(v[..., :1]), torch.cumsum(rest, -1)],
                     -1)
    return v * torch.exp(lead)


def ell_theta(post, log_w):
    """Coefficients (C, K, m) with E_q[log N(x | mu, Lambda)] + log_w =
    features(x) . theta."""
    d = post['mu'].shape[-1]
    a = post['nu'][..., None, None] * post['psi']          # E[Lambda]
    am = torch.einsum('...de,...e->...d', a, post['mu'])
    const = (0.5 * e_logdet(post) - 0.5 * d * LOG2PI
             - 0.5 * d / post['kappa'] - 0.5 * (post['mu'] * am).sum(-1))
    return torch.cat([(const + log_w)[..., None], am,
                      (-0.5 * a).flatten(-2)], -1)


def plugin_theta(mu, lmbda, log_pi):
    """Coefficients (C, K, m) with log N(x | mu, Lambda^-1) + log_pi =
    features(x) . theta."""
    d = mu.shape[-1]
    lm = torch.einsum('...de,...e->...d', lmbda, mu)
    const = (0.5 * logdet(lmbda) - 0.5 * d * LOG2PI
             - 0.5 * (mu * lm).sum(-1))
    return torch.cat([(const + log_pi)[..., None], lm,
                      (-0.5 * lmbda).flatten(-2)], -1)


# -- engines -------------------------------------------------------------------

def positive_definite(post):
    return bool((torch.linalg.cholesky_ex(post['psi'])[1] == 0).all())


def vi_fit(x, prior, start, maxiter, mode='f64'):
    """Mean-field VI from `start` for `maxiter` sweeps: (the posterior
    after the last sweep, the ELBO trace (C, sweeps), ELBO t of the state
    before sweep t). The ELBO is sum_n logsumexp_k [E log pi_k +
    E log N(x_n)] - KL(components) - KL(sticks). In the control's
    precision an update can leave a scale that is not positive definite;
    the fit then stops and returns that update in natural form only
    ({'natural': ...}, as many sweeps as its trace) and the trace."""
    dt = dtype_of(mode)
    prior, post = cast(prior, dt), cast(start, dt)
    n, d = x.shape
    c, k = post['kappa'].shape
    m = 1 + d + d * d
    rows = block_rows(max(m, c * k))
    trace = []
    for _ in range(maxiter):
        theta = ell_theta(post, e_log_pi(post)).reshape(c * k, m)
        s = x.new_zeros((c, k, m), dtype=dt)
        lse_sum = x.new_zeros((c,), dtype=dt)
        for lo in range(0, n, rows):
            f = features(x[lo:lo + rows].to(dt))
            logits = matmul(f, theta.T, mode).reshape(-1, c, k)
            lse = torch.logsumexp(logits, -1)
            resp = torch.exp(logits - lse[..., None])
            lse_sum += lse.sum(0)
            s += matmul(resp.reshape(-1, c * k).T, f, mode).reshape(c, k, m)
        elbo = lse_sum - niw_kl(post, prior).sum(-1) - sb_kl(post, prior)
        stats = (s[..., 0], s[..., 1:1 + d], s[..., 1 + d:].reshape(c, k, d, d))
        post = posterior(prior, *stats)
        trace.append(elbo)
        if mode != 'f64' and not positive_definite(post):
            post = {'natural': natural_update(prior, *stats)}
            break
    return post, torch.stack(trace, -1)


def label_logp(xb, theta, c, k, mode='f64'):
    """log p(z = k | x) (B, C, K) of points xb (B, d) under plug-in
    coefficients theta (C K, m) (plugin_theta, flattened)."""
    f = features(xb.to(dtype_of(mode)))
    return torch.log_softmax(matmul(f, theta.T, mode).reshape(-1, c, k), -1)


def _plugin_rows(x, mu, lmbda, log_pi, mode):
    dt = dtype_of(mode)
    c, k = log_pi.shape
    d = x.shape[1]
    m = 1 + d + d * d
    theta = plugin_theta(mu.to(dt), lmbda.to(dt), log_pi.to(dt))
    return theta.reshape(c * k, m), c, k, block_rows(max(m, c * k))


def label_test(x, mu, lmbda, log_pi, labels, mode='f64'):
    """How far labels (C, N) stray from draws of their conditional
    p(z_n = k) ∝ pi_k N(x_n | mu_k, Lambda_k^-1): per chain and component
    (C, K), (N_k - sum_n p_nk) / sqrt(sum_n p_nk (1 - p_nk) + 1), about
    N(0, 1) for true draws."""
    dt = dtype_of(mode)
    theta, c, k, rows = _plugin_rows(x, mu, lmbda, log_pi, mode)
    count = x.new_zeros((c, k), dtype=dt)
    mean = x.new_zeros((c, k), dtype=dt)
    var = x.new_zeros((c, k), dtype=dt)
    for lo in range(0, x.shape[0], rows):
        logp = label_logp(x[lo:lo + rows], theta, c, k, mode)
        p = torch.exp(logp)
        z = labels[:, lo:lo + rows].T.long()            # (B, C)
        count += torch.nn.functional.one_hot(z, k).to(dt).sum(0)
        mean += p.sum(0)
        var += (p * (1.0 - p)).sum(0)
    return (count - mean) / torch.sqrt(var + 1.0)


def _chi2_z(t, dof):
    """The standard normal quantile of chi2(dof)'s CDF at t, from the
    nearer tail so that neither end rounds to 0 or 1."""
    a, h = 0.5 * dof, 0.5 * t
    lo = torch.special.gammainc(a, h).clamp(min=1e-300)
    hi = torch.special.gammaincc(a, h).clamp(min=1e-300)
    return torch.where(lo < 0.5, torch.special.ndtri(lo),
                       -torch.special.ndtri(hi))


def sticks_of(log_pi):
    """The sticks v_k = pi_k / sum_{j>=k} pi_j of weights log_pi (..., K)
    (the last stick 1), with the tail sums: a tail sum keeps the relative
    precision of the small weights that 1 - sum_{j<k} pi_j loses."""
    pi = torch.exp(log_pi.double())
    tail = torch.flip(torch.cumsum(torch.flip(pi, (-1,)), -1), (-1,))
    return pi / tail, tail


def draw_test(post, mu, lmbda, log_pi):
    """How far parameter draws stray from draws of `post`: the standard
    normal quantile of each draw's probability integral transform, N(0, 1)
    for true draws. Per chain and component, Lambda by tr(psi^-1 Lambda)
    ~ chi2(nu d) and mu by kappa (mu - m)^T Lambda (mu - m) ~ chi2(d);
    the stick of an empty component by its Beta(1, delta) (CDF
    1 - (1 - v)^delta), but not the last stick, nor one whose tail weight
    is under 1e-30. A stick of a component that holds points is left
    out: its count moves between the sweep that drew it and the labels
    that `post` comes from, more than its posterior spread.
    Returns {'mu', 'lmbda', 'sticks'}: 1-D tensors of the kept z."""
    p = cast(post, torch.float64)
    mu, lmbda = mu.double(), lmbda.double()
    d = mu.shape[-1]
    t = torch.diagonal(torch.linalg.solve(p['psi'], lmbda), dim1=-2,
                       dim2=-1).sum(-1)
    dm = mu - p['mu']
    q = p['kappa'] * torch.einsum('...d,...de,...e->...', dm, lmbda, dm)
    v, tail = sticks_of(log_pi)
    empty = (p['gamma'] == 1.0) & (tail >= 1e-30)
    empty[..., -1] = False
    u = -torch.expm1(p['delta'] * torch.log1p(-v.clamp(max=1.0)))
    z_sticks = torch.special.ndtri(u.clamp(1e-300, 1.0 - 1e-16))
    return {'mu': _chi2_z(q, torch.full_like(q, float(d))).flatten(),
            'lmbda': _chi2_z(t, p['nu'] * d).flatten(),
            'sticks': z_sticks[empty]}


MEDIAN_Z2 = 0.4549364231195724     # the median of z^2 for z ~ N(0, 1)
MIN_DRAWS = 32                     # fewer in a group give no reading


def draw_z2_dev(tests):
    """The largest |log(median z^2 / MEDIAN_Z2)| over draw_test's groups of
    at least MIN_DRAWS: about 0 for true draws, far from it for draws of
    the wrong spread (the posterior's mode in place of a draw puts mu's z
    far below -5). A median, so that the few components still moving
    their mass between the sweep that drew them and the final labels do
    not set it."""
    return max((abs(math.log(float(torch.median(z * z)) / MEDIAN_Z2))
                for z in tests.values() if z.numel() >= MIN_DRAWS),
               default=0.0)


def gibbs_labels(x, mu, lmbda, log_pi, gen, mode='f64'):
    """Labels (C, N) drawn from their conditional by Gumbel-max, the
    uniforms from `gen`."""
    dt = dtype_of(mode)
    theta, c, k, rows = _plugin_rows(x, mu, lmbda, log_pi, mode)
    out = []
    for lo in range(0, x.shape[0], rows):
        logp = label_logp(x[lo:lo + rows], theta, c, k, mode)
        u = torch.rand(logp.shape, generator=gen, dtype=dt,
                       device=logp.device)
        g = -torch.log(-torch.log(u.clamp(min=torch.finfo(dt).tiny)))
        out.append(torch.argmax(logp + g, -1).T.to(torch.int32))
    return torch.cat(out, 1)


def predictive(x, post, mode='f64'):
    """Posterior-predictive log-density of points x (N,) under one
    posterior (K-sized leaves): log sum_k E[pi_k] t_k(x), t_k the
    Student-t with df = nu - d + 1, location m, precision
    df psi / (1 + 1 / kappa)."""
    dt = dtype_of(mode)
    post = cast(post, dt)
    n, d = x.shape
    df = post['nu'] - d + 1.0
    prec = (df / (1.0 + 1.0 / post['kappa']))[:, None, None] * post['psi']
    pm = torch.einsum('kde,ke->kd', prec, post['mu'])
    # (x - m)^T P (x - m) = features(x) . [m^T P m, -2 P m, vec P]
    theta = torch.cat([(post['mu'] * pm).sum(-1)[:, None], -2.0 * pm,
                       prec.flatten(1)], 1)
    const = (torch.lgamma(0.5 * (df + d)) - torch.lgamma(0.5 * df)
             - 0.5 * d * torch.log(df * math.pi) + 0.5 * logdet(prec)
             + torch.log(sb_mean(post)))
    rows = block_rows(1 + d + d * d)
    out = []
    for lo in range(0, n, rows):
        q = matmul(features(x[lo:lo + rows].to(dt)), theta.T, mode)
        out.append(torch.logsumexp(
            const - 0.5 * (df + d) * torch.log1p(q.clamp(min=0.0) / df), -1))
    return torch.cat(out)


def natural(post):
    """The posterior as the statistics it accumulates, in float64:
    kappa m, kappa, psi^-1 + kappa m m^T, nu; gamma, delta."""
    p = cast(post, torch.float64)
    outer = p['mu'][..., :, None] * p['mu'][..., None, :]
    return dict(kmu=p['kappa'][..., None] * p['mu'], kappa=p['kappa'],
                scatter=torch.linalg.inv(p['psi'])
                + p['kappa'][..., None, None] * outer,
                nu=p['nu'], gamma=p['gamma'], delta=p['delta'])
