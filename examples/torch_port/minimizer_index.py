"""Example: build a minimizer index (position -> kmer) of a chromosome, on
the PyTorch port.

    python examples/torch_port/minimizer_index.py genome.fa -k 15 -w 10 [--device cuda]

The port's counterpart of ``examples/minimizer_index.py``, with its
arguments and output: (W, K)-minimizer sampling — the seed scheme of
minimap2-style mappers — with each clean segment's windows on the device
(kernel K6 on the card) and the doubling sliding minimum; the sampled
positions cover the sequence with ~2/(W+1) density.
"""

import argparse

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("fasta")
    p.add_argument("-k", type=int, default=15)
    p.add_argument("-w", type=int, default=10)
    p.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (their plain versions)")
    args = p.parse_args()

    import re

    from kmers_tpu_torch.io import read_fastx
    from kmers_tpu_torch.pipelines import minimizer_select

    seq, off = read_fastx(args.fasta)
    index = {}
    span = args.k + args.w - 1
    for i in range(off.size - 1):
        rec = bytes(seq[off[i] : off[i + 1]]).upper()
        # minimizer seeds come from clean segments: split at non-ACGT runs
        # (the standard mapper convention), keeping global offsets
        for m in re.finditer(rb"[ACGT]+", rec):
            segment = m.group(0)
            if len(segment) < span:
                continue
            vals, pos = minimizer_select(segment, K=args.k, W=args.w, device=args.device)
            for v, pp in zip(vals, pos):
                index.setdefault(int(v), []).append((i, m.start() + int(pp)))
    n_pos = sum(len(v) for v in index.values())
    density = n_pos / max(int(seq.size), 1)
    print(
        f"{len(index)} distinct minimizers, {n_pos} positions, "
        f"density {density:.3f} (expected ~{2 / (args.w + 1):.3f})"
    )


if __name__ == "__main__":
    main()
