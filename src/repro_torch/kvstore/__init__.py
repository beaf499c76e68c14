# Case Study I (§4) on the torch port: a distributed key-value store
# (concurrent hash table) built directly on the task-data orchestration
# interface, plus the YCSB workload generators (A/B/C/LOAD with
# Zipf-distributed key access; the JAX package's draws, seed for seed).
from .hashtable import (ChainResult, DistributedHashTable, KVFrontend,
                        KVResult, MultiGetResult)
from .ycsb import (YCSB_WORKLOADS, YCSBWorkload, make_ycsb_batch,
                   make_ycsb_stream, zipf_keys, zipf_keys_stationary)

__all__ = [
    "ChainResult", "DistributedHashTable", "KVFrontend", "KVResult",
    "MultiGetResult",
    "YCSB_WORKLOADS", "YCSBWorkload", "make_ycsb_batch",
    "make_ycsb_stream", "zipf_keys", "zipf_keys_stationary",
]
