"""Command-line front-end: ``python -m kmers_tpu_torch count reads.fa``.

The port's counterpart of ``python -m kmers_tpu``, with the same lines on
stdout and stderr and the same exit codes:

- ``count``: canonical K-mer counting of a FASTA/FASTQ file (``--stream``
  for record batches, ``-o DIR`` to write a count-table checkpoint);
- ``merge``: merge count-table checkpoints (counts sum; K <= 31 tables on
  the device through kernels K9 and K10, K > 31 tables on the host);
- ``verify``: check a checkpoint's recorded inputs (size and sha256);
- ``sketch``, ``dist``: MinHash sketches and Mash distances;
- ``sixframe``: six-frame amino-acid K-mer counting, sharded over every
  GPU as the JAX CLI shards over every device (one rank on the CPU);
- ``bench``: the headline throughput benchmark.

Every command that computes takes ``--device`` (``cuda``, the default, or
``cpu``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys

import numpy as np

_DEVICE_HELP = "torch device: cuda runs the kernels, cpu their plain versions"


def cmd_count(args):
    from .io import read_fastx
    from .kmer import Kmer
    from .pipelines.canonical_count import CountConfig, canonical_count_records
    from .utils import Metrics, checked, save_count_table

    m = Metrics() if args.metrics else None
    ctx = checked() if args.checked else contextlib.nullcontext()
    with ctx:
        if args.stream:
            # never loads the file: record batches stream through the
            # device-resident accumulator, which always checks window
            # conservation
            from .pipelines.streaming import count_fastx_stream

            kmers, counts = count_fastx_stream(
                args.input, CountConfig(K=args.k), metrics=m, device=args.device
            )
        else:
            seq, off = read_fastx(args.input)
            kmers, counts = canonical_count_records(
                seq, off, CountConfig(K=args.k), metrics=m, device=args.device
            )
    if m is not None:
        print(m.dump(), file=sys.stderr)
    if args.output:
        # the inputs' sizes and hashes go into the manifest, for `verify`
        save_count_table(args.output, kmers, counts, K=args.k, inputs=[args.input])
        print(json.dumps({"distinct": int(kmers.size), "total": int(counts.sum()),
                          "output": args.output}))
        return
    top = np.argsort(counts)[::-1][: args.top]
    for i in top:
        k = Kmer.unsafe(args.k, int(kmers[i]))
        print(f"{k}\t{counts[i]}")
    print(
        json.dumps({"distinct": int(kmers.size), "total": int(counts.sum())}),
        file=sys.stderr,
    )


def cmd_merge(args):
    from .pipelines.tables import merge_counts, merge_counts_device, multiplicity_spectrum
    from .utils import load_count_table, save_count_table

    kmers, counts, K = load_count_table(args.inputs[0])
    for d in args.inputs[1:]:
        k2, c2, K2 = load_count_table(d)
        if K2 != K:
            raise SystemExit(f"K mismatch: {d} has K={K2}, expected {K}")
        if K <= 31:
            kmers, counts = merge_counts_device(kmers, counts, k2, c2, device=args.device)
        else:
            kmers, counts = merge_counts(kmers, counts, k2, c2)
    save_count_table(args.output, kmers, counts, K=K)
    spec = multiplicity_spectrum(counts, max_multiplicity=8)
    print(json.dumps({
        "distinct": int(kmers.size), "total": int(counts.sum()),
        "spectrum_1_to_8plus": spec[1:].tolist(), "output": args.output,
    }))


def cmd_verify(args):
    """Deterministic-rerun check: hash the checkpoint's recorded inputs
    again and compare; exit 1 when any changed."""
    from .utils import input_manifest_entry, load_count_table

    kmers, counts, K, manifest = load_count_table(args.checkpoint, return_manifest=True)
    entries = manifest.get("inputs", [])
    if not entries:
        raise SystemExit("checkpoint records no input manifest")
    bad = []
    for want in entries:
        try:
            got = input_manifest_entry(want["path"])
        except OSError as e:
            bad.append({"path": want["path"], "error": str(e)})
            continue
        if got["sha256"] != want["sha256"] or got["bytes"] != want["bytes"]:
            bad.append({"path": want["path"], "expected": want, "found": got})
    print(json.dumps({
        "checkpoint": args.checkpoint, "K": K, "distinct": int(kmers.size),
        "inputs_checked": len(entries), "inputs_changed": bad, "ok": not bad,
    }))
    if bad:
        raise SystemExit(1)


def _sketch_file(path, args):
    from .io import read_fastx
    from .pipelines import join_records_with_n, minhash_sketch

    seq, off = read_fastx(path)
    return minhash_sketch(
        join_records_with_n(seq, off).tobytes(), K=args.k, s=args.size, device=args.device
    )


def cmd_sketch(args):
    if args.stream:
        # never loads the file: chunked, mergeable sketching
        from .pipelines.minhash import sketch_fastx_stream

        sk = sketch_fastx_stream(args.input, K=args.k, s=args.size, device=args.device)
    else:
        sk = _sketch_file(args.input, args)
    # the header records the parameters, so that `dist` can check -k
    print(f"#kmers_tpu sketch k={args.k} s={args.size}")
    for h in sk:
        print(f"{int(h):016x}")


def cmd_dist(args):
    """Mash-style distance between two inputs, each a sketch file written
    by ``sketch`` (header ``#kmers_tpu sketch k=.. s=..`` and one
    16-hex-digit hash a line) or a FASTA/FASTQ file sketched on the fly.  A
    sketch file built with another k than ``-k`` is an error; a file
    without the header is taken with a warning.  Hashes are deduplicated on
    load."""
    from .pipelines.minhash import jaccard

    def load_sketch(path):
        with open(path, "rb") as f:
            head = f.read(1)
        if head in (b">", b"@"):
            return _sketch_file(path, args)
        hashes, saw_header = [], False
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                if line.startswith("#"):
                    if line.startswith("#kmers_tpu sketch"):
                        saw_header = True
                        meta = dict(kv.split("=") for kv in line.split()[2:] if "=" in kv)
                        k_file = int(meta.get("k", args.k))
                        if k_file != args.k:
                            raise SystemExit(
                                f"{path}: sketch was built with k={k_file}, but -k is {args.k}"
                            )
                    continue
                hashes.append(int(line, 16))
        if not saw_header:
            print(f"warning: {path} has no sketch header; assuming k={args.k}", file=sys.stderr)
        return np.unique(np.array(hashes, dtype=np.uint64))

    j = jaccard(load_sketch(args.a), load_sketch(args.b))
    # Mash distance (Ondov et al. 2016): d = -ln(2j / (1 + j)) / k
    d = 1.0 if j <= 0 else min(-math.log(2 * j / (1 + j)) / args.k, 1.0)
    print(json.dumps({"jaccard": round(j, 6), "mash_distance": round(d, 6)}))


def cmd_sixframe(args):
    from .io import read_fastx
    from .parallel import SixFrameCountConfig, data_mesh, sharded_sixframe_aa_count
    from .pipelines import join_records_with_n

    seq, off = read_fastx(args.input)
    # sharded as the JAX CLI's: every GPU (or the process group's ranks);
    # one rank on the CPU
    kmers, counts = sharded_sixframe_aa_count(
        join_records_with_n(seq, off), SixFrameCountConfig(K=args.k),
        data_mesh(device=args.device),
    )
    print(json.dumps({"distinct": int(kmers.size), "total": int(counts.sum())}))


def cmd_bench(args):
    from .pipelines.canonical_count import bench

    print(json.dumps(bench(device=args.device)))


def main(argv=None):
    p = argparse.ArgumentParser(prog="kmers_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    c = sub.add_parser("count", help="canonical K-mer counting (1 <= K <= 100)")
    c.add_argument("input")
    c.add_argument("-k", type=int, default=31)
    c.add_argument("-o", "--output", help="count-table checkpoint directory")
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
        "--stream", action="store_true",
        help="stream the file in record batches instead of loading it "
        "(files larger than host memory; K <= 31)",
    )
    c.add_argument("--device", default="cuda", help=_DEVICE_HELP)
    c.set_defaults(fn=cmd_count)

    vr = sub.add_parser(
        "verify",
        help="check a checkpoint's recorded inputs (size + sha256) so a rerun is known to "
        "see identical data",
    )
    vr.add_argument("checkpoint", help="count-table checkpoint directory")
    vr.set_defaults(fn=cmd_verify)

    mg = sub.add_parser("merge", help="merge count-table checkpoints (counts sum)")
    mg.add_argument("inputs", nargs="+", help="checkpoint directories")
    mg.add_argument("-o", "--output", required=True)
    mg.add_argument("--device", default="cuda", help=_DEVICE_HELP)
    mg.set_defaults(fn=cmd_merge)

    s = sub.add_parser("sketch", help="MinHash sketch")
    s.add_argument("input")
    s.add_argument("-k", type=int, default=16)
    s.add_argument("-s", "--size", type=int, default=1000)
    s.add_argument(
        "--stream", action="store_true",
        help="stream the file in record batches instead of loading it "
        "(files larger than host memory)",
    )
    s.add_argument("--device", default="cuda", help=_DEVICE_HELP)
    s.set_defaults(fn=cmd_sketch)

    d = sub.add_parser("dist", help="Mash-style distance between two sketches/FASTAs")
    d.add_argument("a")
    d.add_argument("b")
    d.add_argument("-k", type=int, default=16)
    d.add_argument("-s", "--size", type=int, default=1000)
    d.add_argument("--device", default="cuda", help=_DEVICE_HELP)
    d.set_defaults(fn=cmd_dist)

    f = sub.add_parser("sixframe", help="six-frame amino-acid K-mer counting (1 <= K <= 32)")
    f.add_argument("input")
    f.add_argument("-k", type=int, default=7)
    f.add_argument("--device", default="cuda", help=_DEVICE_HELP)
    f.set_defaults(fn=cmd_sixframe)

    b = sub.add_parser("bench", help="headline throughput benchmark (canonical 31-mers, 2^26 bases)")
    b.add_argument("--device", default="cuda", help=_DEVICE_HELP)
    b.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
