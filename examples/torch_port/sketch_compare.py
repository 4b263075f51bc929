"""Example: MinHash distance matrix over a set of FASTA files, on the
PyTorch port.

    python examples/torch_port/sketch_compare.py a.fa b.fa c.fa [--device cuda]

The port's counterpart of ``examples/sketch_compare.py``, with its
arguments and output: Mash-style, sketch each input (the s smallest
distinct canonical-kmer FxHashes, kernel K1's hash mode on the card),
estimate pairwise Jaccard, print the matrix.
"""

import argparse


def main():
    p = argparse.ArgumentParser()
    p.add_argument("fastas", nargs="+")
    p.add_argument("-k", type=int, default=16)
    p.add_argument("-s", type=int, default=1000)
    p.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (their plain versions)")
    args = p.parse_args()

    from kmers_tpu_torch.io import read_fastx
    from kmers_tpu_torch.pipelines import jaccard, join_records_with_n, minhash_sketch

    sketches = []
    for path in args.fastas:
        seq, off = read_fastx(path)
        sketches.append(
            minhash_sketch(join_records_with_n(seq, off).tobytes(), K=args.k, s=args.s,
                           device=args.device)
        )

    print("\t" + "\t".join(args.fastas))
    for i, a in enumerate(args.fastas):
        row = [f"{jaccard(sketches[i], sketches[j]):.3f}" for j in range(len(sketches))]
        print(a + "\t" + "\t".join(row))


if __name__ == "__main__":
    main()
