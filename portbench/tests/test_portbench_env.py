"""The run's guards: no JAX module in a run's process (whole top-level
names), and no result without a card."""

import subprocess
import sys
import textwrap

import pytest

import pb_support
from harness import env


def test_forbidden_names_are_compared_whole():
    mods = ['mimo_tpu_torch', 'mimo_tpu_torch.models.mixture', 'torch',
            'jaxtyping', 'flaxen', 'mimo_tpu_torchx']
    assert env.forbidden_modules(mods) == []
    assert env.forbidden_modules(mods + ['mimo_tpu.models']) == ['mimo_tpu']
    assert env.forbidden_modules(['jax.numpy', 'jaxlib', 'flax.linen']) == [
        'flax', 'jax', 'jaxlib']


def test_a_run_loads_no_jax(tmp_path):
    bench = pb_support.small_bench(tmp_path, dtype='float32')
    code = textwrap.dedent(f'''
        import sys
        sys.path[:0] = [{str(pb_support.BENCH)!r}, {str(pb_support.ROOT)!r}]
        import pb_support
        from harness import env
        for w in ('gmm_d2_k50.chains8_vi', 'gmm_d32_k256.serve',
                  'gmm_d2_k50.chains8_gibbs'):
            pb_support.run_small({str(bench)!r}, w, seconds=0.05)
        assert 'mimo_tpu_torch' in sys.modules
        print('FORBIDDEN', env.forbidden_modules())
    ''')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=600,
                         cwd=str(pb_support.BENCH / 'tests'))
    assert out.returncode == 0, out.stderr[-3000:]
    assert 'FORBIDDEN []' in out.stdout


def test_run_without_a_card_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: run.py would measure')
    out = subprocess.run(
        [sys.executable, 'portbench/run.py', '--workload',
         'gmm_d2_k50.chains8_vi', '--seed', str(2 ** 31 + 5), '--seconds',
         '1', '--trace', '0'], capture_output=True, text=True, timeout=300,
        cwd=str(pb_support.ROOT))
    assert out.returncode != 0
    assert out.stdout == ''
    assert 'no CUDA device' in out.stderr
