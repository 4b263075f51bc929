"""Example: canonical k-mer counting of a FASTA file, end to end, on the
PyTorch port.

    python examples/torch_port/count_fasta.py genome.fa -k 31 [--device cuda]

The port's counterpart of ``examples/count_fasta.py``, with its arguments
and output: the whole pipeline (parse -> classify -> window ->
canonicalize -> sort -> count -> fold) runs on the device, kernels K1, K2,
K9 and K10 on the card (``--device cpu`` runs their plain torch versions),
with the table on the device until the final download.  Metrics go to
stderr.
"""

import argparse
import sys

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("fasta")
    p.add_argument("-k", type=int, default=31)
    p.add_argument("--top", type=int, default=10)
    p.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (their plain versions)")
    args = p.parse_args()

    from kmers_tpu_torch.io import read_fastx
    from kmers_tpu_torch.pipelines import CountConfig, canonical_count_records
    from kmers_tpu_torch.utils import Metrics

    metrics = Metrics()
    metrics.start_batch()
    seq, offsets = read_fastx(args.fasta)
    kmers, counts = canonical_count_records(seq, offsets, CountConfig(K=args.k), device=args.device)
    metrics.end_batch(
        bases_in=int(seq.size),
        windows_out=int(counts.sum()),
        distinct_kmers=int(kmers.size),
    )

    from kmers_tpu_torch import DNAAlphabet2, Kmer

    order = np.argsort(counts)[::-1]
    print(f"{kmers.size} distinct canonical {args.k}-mers, "
          f"{counts.sum()} total windows")
    for i in order[: args.top]:
        k = Kmer.unsafe(DNAAlphabet2(), args.k, int(kmers[i]))
        print(f"  {k}\t{counts[i]}")
    print(metrics.dump(), file=sys.stderr)


if __name__ == "__main__":
    main()
