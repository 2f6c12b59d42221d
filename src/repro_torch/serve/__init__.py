"""Serving: scan-prefill and greedy decode over any ported model, and the
bucketed scheduler."""
from .engine import BucketServer, Completion, Request, greedy_generate, scan_prefill

__all__ = ["BucketServer", "Completion", "Request", "greedy_generate", "scan_prefill"]
