"""A model is new files only. In a copy of the benchmark's folder a second
adapter, under another model name, reuses the DP-GMM adapter's calls and
check and brings its own data recipe (blobs of unequal precisions); with
its own configuration, traffic mix and limits it runs a cell to correct,
and no file of the copy changes. A configuration that names no adapter
fails at find_cell; no file of the harness names a model."""

import json
import re
import time

import pytest
import torch

import pb_support
from harness import cells, env, gen, main

MODEL = 'UnequalBlobsGMM'

ADAPTER = '''"""The DP-GMM over blobs of unequal precisions: BayesianGMM's adapter
with its own data recipe (config['data']: n, weights, mean_scale and
one precision a blob)."""

from pathlib import Path

import torch

from harness import cells, gen

gmm = cells.adapter('BayesianGMM', Path(__file__).resolve().parents[1])
make, start, fit, state = gmm.make, gmm.start, gmm.fit, gmm.state
serve, shape, FAULTS = gmm.serve, gmm.shape, gmm.FAULTS
numbers_fit, control_fit = gmm.numbers_fit, gmm.control_fit
numbers_serve, control_serve = gmm.numbers_serve, gmm.control_serve


def blobs(config, seed, n, device, stream):
    spec, d = config['data'], config['make']['dim']
    means = torch.randn((len(spec['weights']), d), device=device,
                        generator=gen.generator(seed, device, 'means'))
    g = gen.generator(seed, device, stream)
    z = torch.multinomial(torch.tensor(spec['weights'], device=device), n,
                          replacement=True, generator=g)
    scale = torch.tensor(spec['precisions'], device=device).rsqrt()
    noise = torch.randn((n, d), generator=g, device=device)
    return means[z] * spec['mean_scale'] + noise * scale[z, None]


def data(config, seed, device):
    return blobs(config, seed, int(config['data']['n']), device, 'data')


def pool(config, seed, n, device):
    return blobs(config, seed, n, device, 'pool')
'''

CONFIG = {'name': 'ublobs_d3_k6', 'model': MODEL,
          'make': {'size': 6, 'dim': 3, 'gating': 'dp', 'alpha': 1.0,
                   'kappa': 0.05, 'psi_scale': 0.5},
          'data': {'n': 6000, 'weights': [0.5, 0.3, 0.2], 'mean_scale': 4.0,
                   'precisions': [4.0, 1.0, 0.25]},
          'dtype': 'float64', 'tf32': False}

TRAFFIC = {
    'fit_vi_two': ({'kind': 'fit', 'engine': 'fit_vi_fused', 'chains': 2,
                    'maxiter': 5, 'start': 'anchor', 'keys': 'fixed',
                    'kernel': 'b1', 'sample': 'all'},
                   {'elbo_gap': 1e-9, 'post_gap': 1e-7}, 'fit_pts_per_s'),
    'serve_small': ({'kind': 'serve', 'dist': 'studentt', 'log2_n': [8, 11],
                     'sizes': 4, 'pool_log2': 12,
                     'posterior': {'engine': 'fit_vi_fused', 'maxiter': 5},
                     'kernel': 'b3', 'sample': 3},
                    {'logp_gap': 1e-9, 'fit_elbo_gap': 1e-9,
                     'fit_post_gap': 1e-7}, 'serve_pts_per_s'),
}


def files(folder):
    return {p: p.read_bytes() for p in folder.rglob('*')
            if p.is_file() and '__pycache__' not in p.parts}


def add_cell(bench, config, traffic):
    """The files and the BENCHMARK.json entries of a cell of `config`
    under `traffic` (a name in TRAFFIC); returns (workload, spec)."""
    mix, limits, metric = TRAFFIC[traffic]
    workload = f"{config['name']}.{traffic}"
    (bench / 'configs' / f"{config['name']}.json").write_text(
        json.dumps(config))
    (bench / 'traffic' / f'{traffic}.json').write_text(json.dumps(mix))
    (bench / 'limits' / f'{workload}.json').write_text(json.dumps(limits))
    spec = pb_support.spec()
    spec['configs'].append({'name': config['name'], 'source': 'x',
                            'file': f"portbench/configs/{config['name']}"
                                    '.json', 'reduced': [], 'why': 'x'})
    spec['workloads'].append({'name': workload, 'config': config['name'],
                              'traffic': traffic, 'chips': 1, 'why': 'x'})
    for m in spec['end_to_end']:
        if m['name'] == metric:
            m['workloads'].append(workload)
    return workload, spec


@pytest.mark.parametrize('traffic', sorted(TRAFFIC))
def test_a_new_model_is_new_files_only(tmp_path, traffic):
    bench = pb_support.small_bench(tmp_path)
    before = files(bench)
    (bench / 'adapters' / f'{MODEL}.py').write_text(ADAPTER)
    workload, spec = add_cell(bench, CONFIG, traffic)
    cell = cells.find_cell(workload, spec, bench)
    adapter = cells.adapter(cell.config['model'], bench)
    assert adapter.__name__ == f'portbench_adapter_{MODEL}'
    x = adapter.data(cell.config, 5, torch.device('cpu'))
    assert x.shape == (6000, 3)
    result, _ = main.run_cell(workload, 2 ** 33 + 11, 0.2, False,
                              torch.device('cpu'), time.perf_counter(),
                              spec=spec, bench=bench, log=lambda m: None)
    assert result['correct'], result['checks']
    assert set(result['checks']) == set(TRAFFIC[traffic][1])
    assert {'setup_s', TRAFFIC[traffic][2]} <= set(result['metrics'])
    after = files(bench)
    for path, data in before.items():
        assert after[path] == data, path
    assert len(after) == len(before) + 4


def test_the_new_model_has_its_own_data(tmp_path):
    """The recipe the copy's adapter brings is the one its cells fit: the
    blobs' spreads follow their precisions."""
    bench = pb_support.small_bench(tmp_path)
    (bench / 'adapters' / f'{MODEL}.py').write_text(ADAPTER)
    adapter = cells.adapter(MODEL, bench)
    config = dict(CONFIG, data=dict(CONFIG['data'], mean_scale=100.0))
    x = adapter.data(config, 7, torch.device('cpu'))
    means = torch.randn((3, 3), generator=gen.generator(7, 'cpu', 'means'))
    z = torch.cdist(x, 100.0 * means).argmin(1)
    var = torch.stack([x[z == j].var(0).mean() for j in range(3)])
    torch.testing.assert_close(var, torch.tensor([0.25, 1.0, 4.0],
                                                 dtype=var.dtype), rtol=0.15,
                               atol=0.0)


def test_a_missing_adapter_fails_at_find_cell(tmp_path):
    bench = pb_support.small_bench(tmp_path)
    config = dict(CONFIG, name='nomodel_d3_k6', model='NoSuchModel')
    workload, spec = add_cell(bench, config, 'fit_vi_two')
    with pytest.raises(LookupError, match=r"no adapter for model "
                       r"'NoSuchModel'.*the adapters are \['BayesianGMM'\]"):
        cells.find_cell(workload, spec, bench)


def test_find_cell_does_not_load_the_adapter(tmp_path):
    """find_cell reads files only: an adapter is loaded (and imports the
    port) where a run sets up, not where its cell is looked up."""
    bench = pb_support.small_bench(tmp_path)
    (bench / 'adapters' / f'{MODEL}.py').write_text(
        "raise RuntimeError('loaded')\n")
    workload, spec = add_cell(bench, CONFIG, 'fit_vi_two')
    cell = cells.find_cell(workload, spec, bench)
    assert cell.config['model'] == MODEL
    with pytest.raises(RuntimeError, match='loaded'):
        cells.adapter(MODEL, bench)


def test_the_harness_names_no_model():
    """Every model specific lives in an adapter: no module of harness/
    names the DP-GMM, its families, its reference or its data."""
    pattern = re.compile(r'BayesianGMM|NIW|StickBreaking|dpgmm|blob')
    modules = sorted((env.BENCH / 'harness').glob('*.py'))
    assert len(modules) >= 10
    found = [f'{p.name}:{i}' for p in modules
             for i, line in enumerate(p.read_text().splitlines(), 1)
             if pattern.search(line)]
    assert found == []
