"""mimo_tpu_torch.utils.plot against mimo_tpu.utils.plot on an Agg
figure: the same inputs (tensors for the port, arrays for JAX's) draw the
same lines and bands to 1e-12; and a driver's --plot writes its PNG."""

import numpy as np
import pytest
import torch

from mimo_tpu_torch.utils import plot as port_plot

matplotlib = pytest.importorskip('matplotlib')
matplotlib.use('Agg')
import matplotlib.pyplot as plt  # noqa: E402

from mimo_tpu.utils import plot as jax_plot  # noqa: E402

torch.set_num_threads(1)


def close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12,
                               atol=1e-12)


@pytest.fixture
def axes():
    fig, (a, b) = plt.subplots(1, 2)
    yield a, b
    plt.close(fig)


def test_plot_gaussian_draws_jax_ellipse(axes):
    rng = np.random.default_rng(0)
    mu = rng.standard_normal(2)
    w = rng.standard_normal((2, 2))
    lmbda = w @ w.T + 0.5 * np.eye(2)
    a, b = axes
    got, = port_plot.plot_gaussian(torch.as_tensor(mu),
                                   torch.as_tensor(lmbda), ax=a,
                                   num_points=77)
    want, = jax_plot.plot_gaussian(mu, lmbda, ax=b, num_points=77)
    close(got.get_xdata(), want.get_xdata())
    close(got.get_ydata(), want.get_ydata())


def test_plot_regression_band_draws_jax_band(axes):
    rng = np.random.default_rng(1)
    x = rng.uniform(-3, 3, (50, 1))
    mean, std, y = np.sin(x), 0.1 + 0.05 * np.abs(x), rng.standard_normal(
        (50, 1))
    a, b = axes
    port_plot.plot_regression_band(torch.as_tensor(x), torch.as_tensor(mean),
                                   torch.as_tensor(std), y=torch.as_tensor(y),
                                   ax=a)
    jax_plot.plot_regression_band(x, mean, std, y=y, ax=b)
    close(a.lines[0].get_xydata(), b.lines[0].get_xydata())
    band_a = a.collections[-1].get_paths()[0].vertices
    band_b = b.collections[-1].get_paths()[0].vertices
    close(band_a, band_b)
    close(a.collections[0].get_offsets(), b.collections[0].get_offsets())


def test_plot_mixture_and_violin_draw_what_jax_draws(axes):
    from mimo_tpu_torch.distributions.niw import GaussParams
    rng = np.random.default_rng(2)
    mu = rng.standard_normal((3, 2)) * 3
    lmbda = np.broadcast_to(np.eye(2) * 2.0, (3, 2, 2)).copy()
    x = rng.standard_normal((40, 2))
    w = np.array([0.5, 0.495, 0.005])
    labels = rng.integers(0, 3, 40)
    a, b = axes
    got = port_plot.plot_mixture(
        torch.as_tensor(x), GaussParams(torch.as_tensor(mu),
                                        torch.as_tensor(lmbda)),
        torch.as_tensor(w), labels=torch.as_tensor(labels), ax=a)
    want = jax_plot.plot_mixture(x, GaussParams(mu, lmbda), w,
                                 labels=labels, ax=b)
    assert len(got) == len(want) == 2       # the third is under min_weight
    for g, v in zip(got, want):
        close(g.get_xydata(), v.get_xydata())
    fig, (c, d) = plt.subplots(1, 2)
    data = [rng.standard_normal(30), rng.standard_normal(20) + 1]
    port_plot.plot_violin_box([torch.as_tensor(v) for v in data],
                              labels=['a', 'b'], ax=c)
    jax_plot.plot_violin_box(data, labels=['a', 'b'], ax=d)
    assert [t.get_text() for t in c.get_xticklabels()] == ['a', 'b']
    for pc, pd in zip(c.collections, d.collections):
        close(pc.get_paths()[0].vertices, pd.get_paths()[0].vertices)
    plt.close(fig)


def test_driver_plot_writes_a_png(tmp_path, monkeypatch):
    from mimo_tpu_torch.examples import dp_sticks, ilr_eval
    monkeypatch.chdir(tmp_path)
    dp_sticks.main(['--cpu', '--plot', '--draws', '2000'])
    ilr_eval.main(['--cpu', '--plot', '--dataset', 'step'])
    for name in ('dp_sticks.png', 'ilr_step.png'):
        assert (tmp_path / name).stat().st_size > 1000
