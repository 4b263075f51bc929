"""The benchmark of ``kmers_tpu_torch`` on NVIDIA cards: ``python -m
kmer_bench --workload <cell> --seed <n> --seconds <s> --trace <0|1>``.
See ``kmer_bench/run.py``."""
