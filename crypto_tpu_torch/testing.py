"""Helpers for the port's CPU tests."""

from __future__ import annotations

import os

import torch


def cap_threads() -> int:
    """Give PyTorch's intra-op pool this process's share of the cores: all
    of them over the number of pytest-xdist workers
    (`PYTEST_XDIST_WORKER_COUNT`, 1 outside xdist), at least one.  Under
    six workers on eight cores each worker's pool would otherwise start
    eight threads, and the CPU-heavy tests would contend for the cores
    about sixfold.  Returns the thread count set."""
    cores = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") \
        else os.cpu_count() or 1
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    n = max(1, cores // max(1, workers))
    torch.set_num_threads(n)
    return n
