"""What the device says about its memory.

Budgets that depend on the card (backpointer tensors, the scheduler's
capacity test) are read from the device itself. A device that reports no
memory size (the CPU backend) gets no budget: nothing here assumes one.
"""

from __future__ import annotations


def device_memory_bytes() -> int | None:
    """``bytes_limit`` of this process's first device, or None if it
    reports none."""
    import jax

    stats = jax.local_devices()[0].memory_stats()
    if not stats or "bytes_limit" not in stats:
        return None
    return int(stats["bytes_limit"])


def path_budget_bytes() -> int | None:
    """Bytes one call may spend on backpointers: half the device memory,
    leaving the rest to the carry, the symbols and XLA's own buffers."""
    limit = device_memory_bytes()
    return None if limit is None else limit // 2
