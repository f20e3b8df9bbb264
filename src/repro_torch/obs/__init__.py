"""Observability (the port of ``repro.obs``): so far the fixed-edge log
histogram the policy matrix reads its tail latencies from."""
from .metrics import BUCKET_HI, BUCKET_LO, N_BUCKETS, Histogram  # noqa: F401

__all__ = ["BUCKET_LO", "BUCKET_HI", "N_BUCKETS", "Histogram"]
