"""Command-line front-end: ``python -m kmers_tpu_torch count reads.fa``.

The port's counterpart of ``python -m kmers_tpu count`` (without ``-o`` and
``--stream``, which are not ported yet): the same top lines on stdout and
the same totals on stderr.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import numpy as np


def cmd_count(args):
    from .io import read_fastx
    from .kmer import Kmer
    from .pipelines.canonical_count import CountConfig, canonical_count_records
    from .utils import Metrics, checked

    m = Metrics() if args.metrics else None
    ctx = checked() if args.checked else contextlib.nullcontext()
    with ctx:
        seq, off = read_fastx(args.input)
        kmers, counts = canonical_count_records(
            seq, off, CountConfig(K=args.k), metrics=m, device=args.device
        )
    if m is not None:
        print(m.dump(), file=sys.stderr)
    top = np.argsort(counts)[::-1][: args.top]
    for i in top:
        k = Kmer.unsafe(args.k, int(kmers[i]))
        print(f"{k}\t{counts[i]}")
    print(
        json.dumps({"distinct": int(kmers.size), "total": int(counts.sum())}),
        file=sys.stderr,
    )


def main(argv=None):
    p = argparse.ArgumentParser(prog="kmers_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    c = sub.add_parser("count", help="canonical K-mer counting (1 <= K <= 100)")
    c.add_argument("input")
    c.add_argument("-k", type=int, default=31)
    c.add_argument("--top", type=int, default=10, help="print N most frequent")
    c.add_argument(
        "--metrics", action="store_true",
        help="print per-batch stats (bases in, windows skipped, ...) to stderr",
    )
    c.add_argument(
        "--checked", action="store_true",
        help="enable checked mode (verifies count conservation)",
    )
    c.add_argument(
        "--device", default="cuda",
        help="torch device: cuda runs the kernels, cpu their plain versions",
    )
    c.set_defaults(fn=cmd_count)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
