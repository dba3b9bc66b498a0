"""Profiling and timing (port of ``utils/profiling.py``): ``time_step``,
the seconds a step takes; ``trace``, a ``torch.profiler`` trace of a
block; and ``device_time_by_kernel``, where a call's time goes on the
card, by kernel, and how much of the wall time the card was busy."""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Optional

import torch


def _wait_for(out) -> None:
    """Wait until the card has computed ``out`` (tensors, possibly nested
    in tuples, lists and dicts): ``torch.cuda.synchronize`` on the device
    of its first CUDA tensor. CPU results are ready when returned."""
    stack = [out]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
                return
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (tuple, list)):
            stack.extend(x)


def time_step(step_fn: Callable, *args, n_steps: int = 20, warmup: int = 5,
              **kwargs) -> Dict[str, float]:
    """Time a step function called repeatedly with the same arguments
    (JAX ``time_step``'s keys: seconds_per_step, steps_per_second,
    total_seconds, n_steps). Waits for the device on the last output
    only, after the warm-up and after the timed steps: the steps queue on
    the card in between."""
    out = None
    for _ in range(warmup):
        out = step_fn(*args, **kwargs)
    _wait_for(out)

    t0 = time.perf_counter()
    for _ in range(n_steps):
        out = step_fn(*args, **kwargs)
    _wait_for(out)
    dt = time.perf_counter() - t0
    return {
        "seconds_per_step": dt / n_steps,
        "steps_per_second": n_steps / dt,
        "total_seconds": dt,
        "n_steps": float(n_steps),
    }


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """A ``torch.profiler`` trace of the block (CPU, and CUDA when a card
    is visible), written to ``log_dir`` as a TensorBoard trace file; a
    no-op when ``log_dir`` is None (JAX ``trace``)."""
    if log_dir is None:
        yield
        return
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


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
