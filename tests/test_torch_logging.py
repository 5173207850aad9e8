"""mimo_tpu_torch/utils/logging.py against mimo_tpu/utils/logging.py: the
same calls write the same JSONL records, apart from the clock `t`."""

import json

import jax.numpy as jnp
import numpy as np
import torch

from mimo_tpu.utils import logging as jlog

from mimo_tpu_torch.utils import logging as tlog


def records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def drive(mod, path, as_tensor):
    log = mod.MetricsLogger(str(path))
    log.log(step=3, elbo=as_tensor(np.float64(-12.5)), note='warm', k=4)
    log.log(rate=as_tensor(np.float32(2.25)))
    log.log_trace('vlb', as_tensor(np.array([-3.0, -2.0, -1.5, -1.25])),
                  every=2)
    with mod.timed('sweep', log):
        pass
    return records(path)


def test_records_equal_jax_apart_from_t(tmp_path):
    want = drive(jlog, tmp_path / 'jax.jsonl', jnp.asarray)
    got = drive(tlog, tmp_path / 'port.jsonl', torch.as_tensor)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert set(g) == set(w) and 't' in g
        g.pop('t'), w.pop('t')
        if 'sweep_seconds' in w:
            assert isinstance(g.pop('sweep_seconds'), float)
            w.pop('sweep_seconds')
        assert g == w


def test_timed_prints_without_a_logger(capsys):
    with tlog.timed('block'):
        pass
    assert capsys.readouterr().out.startswith('block: ')


def test_profile_writes_a_chrome_trace(tmp_path):
    with tlog.profile(str(tmp_path / 'prof')) as prof:
        torch.ones(64) @ torch.ones(64)
    assert (tmp_path / 'prof' / 'trace.json').is_file()
    assert len(prof.key_averages()) > 0
