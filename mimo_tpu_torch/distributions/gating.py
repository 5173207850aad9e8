"""Gating priors: Dirichlet and truncated stick-breaking (DP), with their
conjugate categorical updates, expectations and ELBO terms (port of
mimo_tpu/distributions/gating.py).

Stick-breaking: v_k ~ Beta(gamma_k, delta_k), pi_k = v_k prod_{j<k}(1 - v_j),
truncated at K with v_K = 1.
"""

from typing import NamedTuple

import torch

from mimo_tpu_torch.distributions.wishart import gamma_sample


def _reverse_cumsum_exclusive(counts):
    """N>_k = sum_{j>k} N_j.

    Not `total - cumsum(counts)`: at counts ~ 1e7 that difference has f32
    cancellation error ~ +-2, and a negative N>_{K-1} drives the Beta
    posterior's delta below 0 and the stick KL to NaN. flip-cumsum-flip
    makes the last entry 0 by construction; the clamp guards the one
    remaining rounding subtraction."""
    inclusive_rev = torch.flip(torch.cumsum(torch.flip(counts, (-1,)), -1),
                               (-1,))
    return torch.clamp(inclusive_rev - counts, min=0.0)


def _betaln(a, b):
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


def _exclusive_cumsum(a):
    return torch.cat([torch.zeros_like(a[..., :1]),
                      torch.cumsum(a, -1)[..., :-1]], -1)


class Dirichlet(NamedTuple):
    alpha: torch.Tensor  # (K,)

    @property
    def dim(self):
        return self.alpha.shape[-1]

    @staticmethod
    def standard(size, alpha=1.0, dtype=torch.float32, device=None):
        return Dirichlet(alpha=torch.full((size,), alpha, dtype=dtype,
                                          device=device))

    def update(self, counts):
        """Conjugate categorical update: alpha' = alpha + counts."""
        return Dirichlet(alpha=self.alpha + counts)

    def svi_blend(self, posterior, counts, scale, step):
        """nat' = (1 - step) nat(post) + step (nat(prior) + counts / scale),
        nat = alpha - 1."""
        nat = ((1.0 - step) * (posterior.alpha - 1.0)
               + step * (self.alpha - 1.0 + counts / scale))
        return Dirichlet(alpha=nat + 1.0)

    def mean(self):
        return self.alpha / torch.sum(self.alpha, -1, keepdim=True)

    def mode(self):
        return (self.alpha - 1.0) / (torch.sum(self.alpha, -1, keepdim=True)
                                     - self.dim)

    def sample(self, gen):
        g = gamma_sample(gen, self.alpha)
        return g / torch.sum(g, -1, keepdim=True)

    def expected_log_pi(self):
        """E[log pi_k] = digamma(alpha_k) - digamma(sum alpha)."""
        return (torch.digamma(self.alpha)
                - torch.digamma(torch.sum(self.alpha, -1, keepdim=True)))

    def log_partition(self):
        return (torch.sum(torch.lgamma(self.alpha), -1)
                - torch.lgamma(torch.sum(self.alpha, -1)))

    def kl_divergence(self, other):
        """KL(self || other), the gating ELBO term."""
        inner = torch.sum((self.alpha - other.alpha) * self.expected_log_pi(),
                          -1)
        return other.log_partition() - self.log_partition() + inner

    def label_elbo_terms(self, resp):
        """sum_n sum_k r_nk E[log pi_k]; resp (N, K)."""
        return torch.sum(torch.sum(resp, 0) * self.expected_log_pi())


class StickBreaking(NamedTuple):
    gamma: torch.Tensor  # (K,)
    delta: torch.Tensor  # (K,)

    @property
    def dim(self):
        return self.gamma.shape[-1]

    @staticmethod
    def standard(size, alpha=1.0, dtype=torch.float32, device=None):
        """DP(alpha) truncation: gamma = 1, delta = alpha."""
        return StickBreaking(
            gamma=torch.ones((size,), dtype=dtype, device=device),
            delta=torch.full((size,), alpha, dtype=dtype, device=device))

    def update(self, counts):
        """gamma' = gamma + N_k; delta' = delta + sum_{j>k} N_j."""
        return StickBreaking(gamma=self.gamma + counts,
                             delta=self.delta
                             + _reverse_cumsum_exclusive(counts))

    def svi_blend(self, posterior, counts, scale, step):
        """The blend in standard space (gamma and delta are the shifted
        natural parameters)."""
        acc = _reverse_cumsum_exclusive(counts)
        return StickBreaking(
            gamma=(1.0 - step) * posterior.gamma
            + step * (self.gamma + counts / scale),
            delta=(1.0 - step) * posterior.delta
            + step * (self.delta + acc / scale))

    @staticmethod
    def _probs_from_sticks(betas):
        """pi_k = beta_k * prod_{j<k}(1 - beta_j); beta_K forced to 1."""
        betas = torch.cat([betas[..., :-1], torch.ones_like(betas[..., -1:])],
                          -1)
        log_rest = torch.log1p(-torch.clamp(betas, 0.0, 1.0 - 1e-7))
        return betas * torch.exp(_exclusive_cumsum(log_rest))

    def mean(self):
        return self._probs_from_sticks(self.gamma / (self.gamma + self.delta))

    def mode(self):
        g, d = self.gamma, self.delta
        betas = torch.where((g > 1.0) & (d > 1.0), (g - 1.0) / (g + d - 2.0),
                            torch.where((g <= 1.0) & (d > 1.0), 0.0, 1.0))
        return self._probs_from_sticks(betas)

    def sample(self, gen):
        """Beta(gamma, delta) sticks as a ratio of gamma draws."""
        a = gamma_sample(gen, self.gamma)
        b = gamma_sample(gen, self.delta)
        return self._probs_from_sticks(a / (a + b))

    def expected_log_sticks(self):
        """(E[log v_k], E[log(1 - v_k)])."""
        dg_sum = torch.digamma(self.gamma + self.delta)
        return (torch.digamma(self.gamma) - dg_sum,
                torch.digamma(self.delta) - dg_sum)

    def expected_log_pi(self):
        """E[log pi_k] = E[log v_k] + sum_{j<k} E[log(1-v_j)]."""
        e_stick, e_rest = self.expected_log_sticks()
        return e_stick + _exclusive_cumsum(e_rest)

    def log_partition(self):
        return torch.sum(_betaln(self.gamma, self.delta), -1)

    def kl_divergence(self, other):
        e_stick, e_rest = self.expected_log_sticks()
        inner = torch.sum((self.gamma - other.gamma) * e_stick
                          + (self.delta - other.delta) * e_rest, -1)
        return other.log_partition() - self.log_partition() + inner

    def label_elbo_terms(self, resp):
        """sum_n [r_nk E[log v_k] + (sum_{j>k} r_nj) E[log(1-v_k)]]."""
        counts = torch.sum(resp, 0)
        e_stick, e_rest = self.expected_log_sticks()
        return torch.sum(counts * e_stick
                         + _reverse_cumsum_exclusive(counts) * e_rest)
