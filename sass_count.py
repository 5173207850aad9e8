#!/usr/bin/env python3
"""Count the instructions of the serving kernels' loops in the SASS that
nvcc built, on a machine with the CUDA toolkit.

    python3 sass_count.py [--tree DIR] [--label NAME] [--out FILE]
                          [--kernel REGEX ...]

Builds (or reuses) the kernel library of the mimo_tpu_torch checkout
under DIR (default: this script's directory), disassembles it with
`cuobjdump -sass`, and for each kernel whose mangled name matches one of
the regexes (default: B4 `diag_predict_kernel<2>` and B3
`predict_kernel<kGauss, 2>`) finds its loops (a backward branch and its
target) and prints, per loop, its length and its instructions by class:
MUFU (each function), f32 arithmetic (FFMA, FMUL, FADD, FMNMX, FSETP,
FSEL), shared and global loads, and the rest. The MUFU.EX2 count of the
innermost K loop is the number of components one trip handles, so the
instructions per (point, component) are its length over that count and
the points a thread owns. The kernels' whole listings go to FILE
(default build/sass_<label>.txt) for reading by hand. Prints one
JSON line with the counts last.
"""

import argparse
import collections
import json
import re
import subprocess
import sys
from pathlib import Path

DEFAULT_KERNELS = (r'diag_predict_kernelILi2EE', r'predict_kernelILi0ELi2EE')
CLASSES = (('mufu', re.compile(r'^MUFU')),
           ('f32', re.compile(r'^(FFMA|FMUL|FADD|FMNMX|FSETP|FSEL|FCHK)')),
           ('lds', re.compile(r'^LDS')),
           ('ldg', re.compile(r'^(LDG|LD\b|LDC)')))
INSN = re.compile(r'/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;')
LABEL = re.compile(r'^\s*\.(L_x_\d+):')


def functions(sass):
    """{mangled name: [(address, text)]} from cuobjdump -sass output, with
    label lines kept as (address of the next instruction, '.L_x_n:')."""
    out, name, body, pending = {}, None, [], []
    for line in sass.splitlines():
        m = re.search(r'Function\s*:\s*(\S+)', line)
        if m:
            if name:
                out[name] = body
            name, body, pending = m.group(1), [], []
            continue
        if name is None:
            continue
        m = LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = INSN.search(line)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                body.append((addr, f'.{lab}:'))
            pending = []
            body.append((addr, m.group(2)))
    if name:
        out[name] = body
    return out


def opcode(text):
    t = re.sub(r'^@!?U?P\w+\s+', '', text)
    return t.split()[0] if t.split() else ''


def loops(body):
    """(start, end) address ranges of the loops: a branch whose target
    lies at or before it."""
    labels = {t[1:-1]: a for a, t in body if t.startswith('.')}
    found = []
    for addr, text in body:
        if opcode(text) != 'BRA':
            continue
        m = re.search(r'`\(\.(L_x_\d+)\)', text) or re.search(
            r'BRA\s+(?:\w+\s+)?(0x[0-9a-f]+)', text)
        if not m:
            continue
        tgt = labels.get(m.group(1)) if m.group(1).startswith('L_x') else \
            int(m.group(1), 16)
        if tgt is not None and tgt <= addr:
            found.append((tgt, addr))
    return sorted(set(found))


def histogram(body, lo, hi):
    cls, mufu = collections.Counter(), collections.Counter()
    n = 0
    for addr, text in body:
        if text.startswith('.') or not lo <= addr <= hi:
            continue
        op = opcode(text)
        n += 1
        for c, rx in CLASSES:
            if rx.match(op):
                cls[c] += 1
                if c == 'mufu':
                    mufu[op] += 1
                break
        else:
            cls['other'] += 1
    return n, dict(cls), dict(mufu)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--tree', default=str(Path(__file__).resolve().parent))
    ap.add_argument('--label', default='this')
    ap.add_argument('--out', default=None)
    ap.add_argument('--kernel', action='append', default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))
    from mimo_tpu_torch.ops import _build
    lib = _build.load()
    cuobjdump = Path(_build._nvcc()).with_name('cuobjdump')
    sass = subprocess.run([str(cuobjdump), '-sass', str(lib.path)],
                          capture_output=True, text=True, check=True).stdout
    funcs = functions(sass)
    pats = [re.compile(p) for p in (args.kernel or DEFAULT_KERNELS)]
    out = Path(args.out or f'build/sass_{args.label}.txt')
    out.parent.mkdir(parents=True, exist_ok=True)
    record, listing = {}, []
    for name, body in sorted(funcs.items()):
        if not any(p.search(name) for p in pats):
            continue
        n = sum(1 for _, t in body if not t.startswith('.'))
        rows = []
        for lo, hi in loops(body):
            ln, cls, mufu = histogram(body, lo, hi)
            rows.append({'from': hex(lo), 'to': hex(hi), 'insns': ln,
                         'classes': cls, 'mufu': mufu})
            print(f'{args.label} {name} loop {hex(lo)}-{hex(hi)}: {ln} '
                  f'instructions {cls} MUFU {mufu}')
        record[name] = {'insns': n, 'loops': rows}
        listing.append(f'== {name} ({n} instructions)\n' + '\n'.join(
            f'{a:#06x} {t}' for a, t in body))
    out.write_text('\n\n'.join(listing) + '\n')
    print(f'{args.label}: listings of {len(record)} kernels in {out}')
    print(json.dumps({'label': args.label, 'kernels': record}))


if __name__ == '__main__':
    main()
