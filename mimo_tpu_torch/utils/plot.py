"""Plotting helpers: Gaussian covariance ellipses, fitted mixtures,
regression bands and violin plots (port of mimo_tpu/utils/plot.py).

Each function takes tensors (on any device) or arrays and imports
matplotlib only when called, so that the package and the drivers import
without it (the card's machine has none).
"""

import numpy as np

from mimo_tpu_torch.utils.data import to_numpy


def plot_gaussian(mu, lmbda, color='b', label='', alpha=1.0, ax=None,
                  num_points=100):
    """Covariance ellipse (2 standard deviations) of N(mu, lmbda^{-1}),
    given the precision `lmbda`."""
    import matplotlib.pyplot as plt
    ax = ax or plt.gca()
    mu = to_numpy(mu)
    cov = np.linalg.inv(to_numpy(lmbda))
    t = np.linspace(0, 2 * np.pi, num_points)
    circle = np.vstack([np.sin(t), np.cos(t)])
    ellipse = 2.0 * np.linalg.cholesky(cov) @ circle
    line, = ax.plot(ellipse[0] + mu[0], ellipse[1] + mu[1],
                    linestyle='-', linewidth=2, color=color, label=label,
                    alpha=alpha)
    return [line]


def plot_mixture(x, params, weights, labels=None, ax=None, min_weight=0.01):
    """Scatter of x (N, 2) coloured by `labels`, and the ellipse of each
    component (params.mu, params.lmbda) whose weight is >= min_weight."""
    import matplotlib.pyplot as plt
    ax = ax or plt.gca()
    x = to_numpy(x)
    weights = to_numpy(weights)
    cmap = plt.get_cmap('tab10')
    if labels is not None:
        colors = [cmap(lab % 10) for lab in to_numpy(labels)]
        ax.scatter(x[:, 0], x[:, 1], c=colors, marker='+', alpha=0.4)
    else:
        ax.scatter(x[:, 0], x[:, 1], marker='+', alpha=0.4)
    mu, lmbda = to_numpy(params.mu), to_numpy(params.lmbda)
    artists = []
    for j in range(weights.shape[0]):
        if weights[j] >= min_weight:
            artists += plot_gaussian(mu[j], lmbda[j], color=cmap(j % 10),
                                     ax=ax)
    return artists


def plot_regression_band(x, mean, std, y=None, ax=None, color='C0'):
    """The prediction curve over sorted x with a +/- 2 std band, over the
    data (x, y) when y is given."""
    import matplotlib.pyplot as plt
    ax = ax or plt.gca()
    x = to_numpy(x).ravel()
    order = np.argsort(x)
    xs = x[order]
    ms, ss = to_numpy(mean).ravel()[order], to_numpy(std).ravel()[order]
    if y is not None:
        ax.scatter(x, to_numpy(y).ravel(), s=4, alpha=0.3, color='gray')
    ax.plot(xs, ms, color=color)
    ax.fill_between(xs, ms - 2 * ss, ms + 2 * ss, alpha=0.25, color=color)
    return ax


def plot_violin_box(data, labels=None, ax=None):
    """Violin and box plot of each array in `data`."""
    import matplotlib.pyplot as plt
    ax = ax or plt.gca()
    data = [to_numpy(d) for d in data]
    ax.violinplot(data, showmeans=False, showextrema=False)
    ax.boxplot(data, widths=0.15)
    if labels is not None:
        ax.set_xticks(np.arange(1, len(data) + 1), labels=labels)
    return ax
