"""Run ``chip_smoke.py``'s last phase alone on one GPU: build the kernels,
make the synthetic chromosome, compute the two tables the phase holds the
examples against (K = 31 counting of the chromosome and the streamed
400,000-read FASTQ, as phases 4 and 8 compute them), then run
``phase_docs_examples``: every block of ``docs/torch_port/*.md`` on the card
and the four ``examples/torch_port`` scripts with ``--device cuda``.

    python tools/docs_smoke.py
"""

from __future__ import annotations

import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    import chip_smoke as cs
    from kmers_tpu_torch import CountConfig, canonical_count_bytes, count_fastx_stream

    smi = cs.phase_device()
    cs.phase_build()
    chrom = cs.synth_chromosome(cs.CHR21_BASES, seed=21)
    t0 = time.perf_counter()
    expect_31 = cs.count_fasta_stdout(*canonical_count_bytes(chrom, CountConfig(K=cs.K), device="cuda"), cs.K)
    with tempfile.TemporaryDirectory() as tmp:
        fq = Path(tmp) / "reads.fq"
        cs.write_fastq(fq, cs.sample_reads(chrom, cs.READS, cs.READ_LEN, seed=8))
        table = count_fastx_stream(fq, CountConfig(K=cs.K), batch_bytes=cs.STREAM_BATCH, device="cuda")
    expect_stream = cs.stream_count_stdout(*table, cs.K)
    cs.log(f"[setup] the two tables' expected lines in {time.perf_counter() - t0:.1f} s")
    launches = cs.phase_docs_examples(chrom, smi, expect_31, expect_stream)
    cs.log(f"[docs] launches {launches}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
