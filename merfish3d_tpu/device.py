"""What the program needs to know of the device it runs on.

One place reads the accelerator's identity and memory limit; every memory
budget in the package is a fraction of :func:`bytes_limit`. The budgets
were first sized for a device with a 16 GiB limit, so each is written as
its value at that limit (:data:`REFERENCE_BYTES_LIMIT`) and scaled by
:func:`scale_budget`: a 16 GiB device gets the original numbers, an H100
(about 64 GB usable under JAX's default memory fraction) gets about
3.7 times as much.
"""

from __future__ import annotations

import jax

# the limit the budgets below were calibrated against; the CPU backend
# reports no memory limit, so it is budgeted as this device too
REFERENCE_BYTES_LIMIT = 16 << 30


def bytes_limit() -> int:
    """Device memory available to this process (``memory_stats()
    ["bytes_limit"]`` of the first device; :data:`REFERENCE_BYTES_LIMIT`
    where the backend reports none)."""
    stats = jax.devices()[0].memory_stats() or {}
    return int(stats.get("bytes_limit", REFERENCE_BYTES_LIMIT))


def scale_budget(value_at_reference: float) -> float:
    """A budget sized for a :data:`REFERENCE_BYTES_LIMIT` device, scaled
    to this device's memory limit."""
    return float(value_at_reference) * bytes_limit() / REFERENCE_BYTES_LIMIT


def describe() -> dict:
    """Platform, device kind and count, as every measurement reports them."""
    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}
