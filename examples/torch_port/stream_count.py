"""Count canonical k-mers of a FASTA/FASTQ file WITHOUT loading it, on the
PyTorch port.

The port's counterpart of ``examples/stream_count.py``, with its arguments
and output: ``stream_fastx`` yields record batches (records never split
across batches), ``StreamingCounter`` folds them into its accumulator on
the device (kernels K1, K2, K9 and K10 on the card), and the final table
is identical to counting the whole file at once.

    python examples/torch_port/stream_count.py reads.fa[.gz] [K] [--device cuda]
"""

import argparse
import sys

from kmers_tpu_torch.io import stream_fastx
from kmers_tpu_torch.pipelines import CountConfig, StreamingCounter


def main():
    p = argparse.ArgumentParser()
    p.add_argument("path")
    p.add_argument("K", type=int, nargs="?", default=31)
    p.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (their plain versions)")
    args = p.parse_args()
    K = args.K

    sc = StreamingCounter(CountConfig(K=K), device=args.device)
    for batch, (seq, offsets) in enumerate(
        stream_fastx(args.path, batch_bytes=1 << 26)
    ):
        sc.update(seq, offsets)
        print(
            f"batch {batch}: {offsets.size - 1} records, "
            f"{sc.bases_seen:,} bases so far",
            file=sys.stderr,
        )

    kmers, counts = sc.finalize()
    print(f"distinct canonical {K}-mers: {kmers.size:,}")
    print(f"total counted windows:      {int(counts.sum()):,}")
    top = counts.argsort()[::-1][:5]
    from kmers_tpu_torch import DNAAlphabet2, Kmer

    for i in top:
        k = Kmer.unsafe(DNAAlphabet2(), K, int(kmers[i]))
        print(f"  {k}  x{counts[i]}")


if __name__ == "__main__":
    main()
