"""Device-time attribution with ``torch.profiler`` (the port's side of
``utils/profiling.py``): where a call's time goes on the card, by kernel,
and how much of the wall time the card was busy."""

from __future__ import annotations

import time
from typing import Callable, Dict

import torch


def device_time_by_kernel(fn: Callable[[], object], iters: int = 3) -> Dict:
    """Run ``fn`` ``iters`` times under the profiler (CPU and CUDA
    activities) and return::

        {"wall_ms": host time of the window, ending in a synchronize,
         "device_ms": summed kernel and copy time on the card,
         "kernels": [(name, calls, total_ms), ...] largest first}

    ``device_ms / wall_ms`` is the card's busy share (kernels on one
    stream do not overlap). Warm ``fn`` up before calling this.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for avg in prof.key_averages():
        # a user annotation (e.g. ``Optimizer.step#...``) spans kernels
        # that are counted on their own
        if (avg.device_type != DeviceType.CUDA
                or getattr(avg, "is_user_annotation", False)):
            continue
        rows.append((avg.key, avg.count, avg.self_device_time_total / 1e3))
    rows.sort(key=lambda r: -r[2])
    return {"wall_ms": wall_ms,
            "device_ms": sum(r[2] for r in rows),
            "kernels": rows}
