"""Every configuration, traffic mix, limit file, metric and work count of
BENCHMARK.json loads by name, BENCHMARK.json keeps to its contract's
shape, and a new cell's files are found without editing any file."""

import json
import re
import shutil

import pytest

import pb_support
from harness import cells, env

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


def test_benchmark_json_shape():
    spec = pb_support.spec()
    assert set(spec) == {'command', 'paths', 'run_seconds', 'configs',
                         'workloads', 'end_to_end', 'per_layer'}
    assert spec['paths'] == ['portbench']
    assert spec['command'] == ['python3', 'portbench/run.py']
    assert 1 <= spec['run_seconds'] <= 51
    e2e = {m['name'] for m in spec['end_to_end']}
    assert 'setup_s' in e2e
    names = [x['name'] for k in ('configs', 'workloads', 'end_to_end',
                                 'per_layer') for x in spec[k]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for c in spec['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert c['file'].startswith('portbench/')
        assert (env.ROOT / c['file']).is_file()
        assert any(w['config'] == c['name'] for w in spec['workloads'])
        assert len(c['why']) <= 200 and len(c['source']) <= 200
    for w in spec['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert w['chips'] == 1 and len(w['why']) <= 200
    for m in spec['end_to_end'] + spec['per_layer']:
        assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
    for m in spec['end_to_end']:
        assert 0.0 < m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
    for m in spec['per_layer']:
        assert m['moves'] in e2e and '\n' not in m['layer']
        for w in m['workloads']:
            e = next(x for x in spec['end_to_end'] if x['name'] == m['moves'])
            assert cells.reports(e, w), (m['name'], w)


@pytest.mark.parametrize('workload', [w['name'] for w in
                                      pb_support.spec()['workloads']])
def test_cell_files_load_by_name(workload):
    cell = cells.find_cell(workload)
    assert cell.config['name'] == workload.split('.')[0]
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    names = [m['name'] for m in cell.end_to_end]
    assert 'setup_s' in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cells.metric_reader(m['name']))
    work = cells.work_count(cell.traffic['kernel'])
    assert callable(work.count) and work.KERNELS
    adapter = cells.adapter(cell.config['model'])
    for name in ('make', 'data', 'start', 'fit', 'state', 'pool', 'serve',
                 'shape', 'numbers_fit', 'control_fit', 'numbers_serve',
                 'control_serve'):
        assert callable(getattr(adapter, name)), name
    assert all(callable(f) for f in adapter.FAULTS.values())


def test_new_files_are_found_without_edits(tmp_path):
    bench = tmp_path / 'portbench'
    shutil.copytree(env.BENCH, bench, ignore=shutil.ignore_patterns(
        'tests', '__pycache__'))
    before = {p: p.read_bytes() for p in bench.rglob('*') if p.is_file()}
    cfg = json.loads((bench / 'configs' / 'gmm_d2_k50.json').read_text())
    cfg['name'] = 'gmm_d4_k20'
    cfg['make'].update(dim=4, size=20)
    (bench / 'configs' / 'gmm_d4_k20.json').write_text(json.dumps(cfg))
    (bench / 'traffic' / 'fit_vi_long.json').write_text(json.dumps(
        {'kind': 'fit', 'engine': 'fit_vi_fused', 'chains': 2,
         'maxiter': 40, 'start': 'anchor', 'keys': 'fixed',
         'kernel': 'b9', 'sample': 'all'}))
    (bench / 'limits' / 'gmm_d4_k20.long.json').write_text(
        json.dumps({'elbo_gap': 1e-5}))
    (bench / 'metrics' / 'sweeps_s.fit.py').write_text(
        'def read(ctx):\n    return 42.0\n')
    (bench / 'work' / 'b9.py').write_text(
        "KERNELS = r'b9'\n\ndef count(shape):\n    return 1, 2\n")
    spec = pb_support.spec()
    spec['configs'].append({'name': 'gmm_d4_k20', 'source': 'x',
                            'file': 'portbench/configs/gmm_d4_k20.json',
                            'reduced': [], 'why': 'x'})
    spec['workloads'].append({'name': 'gmm_d4_k20.long',
                              'config': 'gmm_d4_k20',
                              'traffic': 'fit_vi_long', 'chips': 1,
                              'why': 'x'})
    spec['per_layer'].append({'name': 'sweeps_s.fit', 'unit': '1/s',
                              'better': 'higher', 'source': 'program_span',
                              'layer': 'engines', 'moves': 'fit_pts_per_s',
                              'workloads': ['gmm_d4_k20.long']})
    cell = cells.find_cell('gmm_d4_k20.long', spec, bench)
    assert cell.config['make']['dim'] == 4 and cell.traffic['maxiter'] == 40
    assert [m['name'] for m in cell.per_layer] == ['sweeps_s.fit']
    assert cells.metric_reader('sweeps_s.fit', bench)(None) == 42.0
    assert cells.work_count('b9', bench).count({}) == (1, 2)
    for path, data in before.items():
        assert path.read_bytes() == data, path
