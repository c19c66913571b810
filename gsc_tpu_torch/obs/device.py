"""Device memory gauges from the CUDA caching allocator.

The port of ``gsc_tpu.obs.device``: one record per visible CUDA device
with the JAX package's keys, ``bytes_in_use`` and ``peak_bytes_in_use``
(``torch.cuda.memory_stats``: ``allocated_bytes.all.current`` and
``.peak``) and ``bytes_limit`` (the device's total memory from
``torch.cuda.mem_get_info``).  Without a card one ``available: false``
record names the CPU backend, so a report written against a CPU run
reads a card run unchanged.
"""
from __future__ import annotations

from typing import Dict, List, Optional

_KEYS = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")


def device_memory_snapshot() -> List[Dict]:
    """``[{"device", "available", "backend", bytes_in_use,
    peak_bytes_in_use, bytes_limit}]``; on the CPU one record with
    ``available: false``."""
    import torch

    if not torch.cuda.is_available():
        return [{"device": "cpu", "available": False, "backend": "cpu"}]
    records = []
    for i in range(torch.cuda.device_count()):
        rec: Dict = {"device": f"cuda:{i}", "available": True,
                     "backend": "gpu"}
        try:
            stats = torch.cuda.memory_stats(i)
            _, total = torch.cuda.mem_get_info(i)
        except Exception:    # a device that cannot report keeps the record
            rec["available"] = False
            records.append(rec)
            continue
        rec["bytes_in_use"] = int(stats.get("allocated_bytes.all.current", 0))
        rec["peak_bytes_in_use"] = int(stats.get("allocated_bytes.all.peak",
                                                 0))
        rec["bytes_limit"] = int(total)
        records.append(rec)
    return records


def record_device_gauges(hub, records: Optional[List[Dict]] = None
                         ) -> List[Dict]:
    """Sample (or reuse) a memory snapshot and mirror it into hub gauges
    tagged by device (``gsc_device_bytes_in_use{device="cuda:0"}``)."""
    if records is None:
        records = device_memory_snapshot()
    for rec in records:
        for k in _KEYS:
            if k in rec:
                hub.gauge(f"device_{k}", rec[k], device=rec["device"])
    return records
