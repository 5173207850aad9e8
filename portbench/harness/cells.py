"""Everything of a cell found by name: BENCHMARK.json's entry, then
configs/<config>.json, adapters/<model>.py (the configuration's `model`),
traffic/<traffic>.json, limits/<workload>.json, metrics/<metric>.py and
work/<kernel>.py under the benchmark's folder. Adding a model, a
configuration, a traffic mix, a metric or a kernel's work count is
adding a file and an entry; no file here changes."""

import importlib.util
import json
from pathlib import Path
from typing import Any, NamedTuple

from harness.env import BENCH, ROOT


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list      # BENCHMARK.json metric entries this cell reports
    per_layer: list
    bench: Path           # the folder the files were found under


def load_json(path):
    with open(path) as f:
        return json.load(f)


def reports(metric, workload):
    """Whether a metric entry is reported in `workload`: listed there, or
    without a `workloads` key."""
    return workload in metric.get('workloads', [workload])


def find_cell(workload, spec=None, bench=BENCH):
    """The Cell of `workload` from `spec` (default BENCHMARK.json at the
    checkout's root), its files under `bench`."""
    spec = spec if spec is not None else load_json(ROOT / 'BENCHMARK.json')
    entries = {w['name']: w for w in spec['workloads']}
    if workload not in entries:
        raise KeyError(f'no workload {workload!r} in BENCHMARK.json; one of '
                       f'{sorted(entries)}')
    w = entries[workload]
    bench = Path(bench)
    config = load_json(bench / 'configs' / f"{w['config']}.json")
    traffic = load_json(bench / 'traffic' / f"{w['traffic']}.json")
    limits = load_json(bench / 'limits' / f'{workload}.json')
    adapter_path(config['model'], bench)
    return Cell(workload, int(w['chips']), config, traffic, limits,
                [m for m in spec['end_to_end'] if reports(m, workload)],
                [m for m in spec['per_layer'] if reports(m, workload)],
                bench)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise ImportError(f'cannot load {path}')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def adapter_path(model, bench=BENCH):
    """adapters/<model>.py, which has to exist; it is not loaded here."""
    folder = Path(bench) / 'adapters'
    path = folder / f'{model}.py'
    if not path.is_file():
        have = sorted(p.stem for p in folder.glob('*.py'))
        raise LookupError(f'no adapter for model {model!r}: no {path}; '
                          f'the adapters are {have}')
    return path


def adapter(model, bench=BENCH):
    """adapters/<model>.py loaded: the model's calls, data, starts,
    work-count shape, check and faults (the interface: the adapter's
    docstring and the README's "To add a model"). It imports the port;
    a run loads it once, in main.set_up."""
    return load_module(adapter_path(model, bench),
                       f'portbench_adapter_{model}')


def metric_reader(name, bench=BENCH):
    """metrics/<name>.py's read(ctx) -> number or None."""
    return load_module(Path(bench) / 'metrics' / f'{name}.py',
                       f'portbench_metric_{name}').read


def work_count(kernel, bench=BENCH) -> Any:
    """work/<kernel>.py: count(shape) -> (MACs, bytes) and KERNELS, the
    device kernel names (substrings) that do that work."""
    return load_module(Path(bench) / 'work' / f'{kernel}.py',
                       f'portbench_work_{kernel}')


def peaks(bench=BENCH):
    return load_json(Path(bench) / 'work' / 'peaks.json')
