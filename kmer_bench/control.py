"""The control of a cell: its run with the entry's control in the
program's place (the plain reference with one guarantee of the
configuration broken), checked as a run is checked.

    python -m kmer_bench.control --workload jellyfish_k31.chr21 --seeds 1 2 3 --seconds 1

One line per seed: the check's numbers, each with its limit.  Every
number must exceed its limit on some line for the check to tell the
control from the program: the readings in ``PERF.md`` come from here.
The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import time

from kmer_bench import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m kmer_bench.control", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    run.cache_env()
    import torch

    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in args.seeds:
        cell = run.resolve(args.workload)
        t0 = time.time()
        out = run.run_cell(cell, seed, args.seconds, False, device, t0, control=True)
        line = run.result_line(cell, out, False)
        print(json.dumps({"workload": cell.name, "seed": seed, "correct": line["correct"],
                          "attempted": line["attempted"], "check": line["check"],
                          "seconds": time.time() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
