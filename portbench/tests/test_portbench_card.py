"""On the card: each cell's command runs through a short window and comes
out correct, its result line as the contract has it; the TF32 control
comes out not correct. Marked cuda: without a card they skip."""

import json
import subprocess
import sys

import pytest

import pb_support

CELLS = [w['name'] for w in pb_support.spec()['workloads']]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')


def run(*args):
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, timeout=1500, cwd=str(pb_support.ROOT))


@pytest.mark.cuda
@pytest.mark.parametrize('trace', [0, 1])
@pytest.mark.parametrize('workload', CELLS)
def test_cell_on_card(card, workload, trace):
    out = run('portbench/run.py', '--workload', workload, '--seed',
              str(2 ** 31 + 101), '--seconds', '2', '--trace', str(trace))
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result['correct'], result['checks']
    assert result['device']['platform'] == 'gpu'
    assert result['device']['count'] == 1
    assert list(result)[-1] == 'checks'
    spec = pb_support.spec()
    kind = 'per_layer' if trace else 'end_to_end'
    want = {m['name'] for m in spec[kind]
            if workload in m.get('workloads', [workload])}
    assert set(result['metrics']) == want
    if trace:
        assert 0 < result['device']['busy_s'] <= result['device']['window_s']
        for name, m in result['metrics'].items():
            if 'roofline' in name or 'mfu' in name:
                assert 0 < m['value'] <= 100, name


@pytest.mark.cuda
@pytest.mark.parametrize('workload', CELLS)
def test_control_on_card_is_not_correct(card, workload, tmp_path):
    out_file = tmp_path / 'calib.jsonl'
    out = run('portbench/calibrate.py', '--workload', workload, '--seeds',
              '', '--control-seeds', f'{2 ** 31 + 7},{2 ** 31 + 9},'
              f'{2 ** 31 + 11}', '--seconds', '1', '--out', str(out_file))
    assert out.returncode == 0, out.stderr[-3000:]
    rows = [json.loads(line) for line in out_file.read_text().splitlines()]
    assert len(rows) == 3 and not any(r['correct'] for r in rows)
