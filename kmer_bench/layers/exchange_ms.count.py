"""exchange_ms.count: device ms per call of the collectives' kernels
(NCCL: the exchange's ``all_to_all_single``, the gathers and the
reductions of the sharded call) on this process's card."""

from kmer_bench.trace import group_ms


def claims(name: str) -> bool:
    return "nccl" in name.lower()


def read(tr):
    return group_ms(tr, claims)
