"""Device-time breakdown of one more run of a serving step, shared by the
serving launchers' ``--profile``."""
from __future__ import annotations

import torch

__all__ = ["sync", "profile_once", "print_profile"]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile_once(fn, device: torch.device, wall_s: float,
                 top: int = 12) -> dict:
    """Run ``fn()`` once more under ``torch.profiler``: device time by kernel
    name, and the device's busy share of an unprofiled run that took
    ``wall_s`` (the profiler's own overhead inflates the profiled run's
    wall time)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        fn()
        sync(device)
    rows = []
    for e in prof.key_averages():
        # device-side rows only: operator rows repeat their kernels' time
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0)
        if dev > 0:
            rows.append((float(dev), e.key, int(e.count)))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    return {"wall_us": wall_s * 1e6, "device_us": busy,
            "busy_share": busy / (wall_s * 1e6),
            "device_kernels": sum(r[2] for r in rows),
            "top": [{"name": k[:80], "device_us": d, "calls": c}
                    for d, k, c in rows[:top]]}


def print_profile(tag: str, what: str, pr: dict) -> None:
    print(f"[{tag}] profiled {what}: device busy {pr['device_us']:.0f} us "
          f"of a {pr['wall_us']:.0f} us {what} "
          f"({100 * pr['busy_share']:.1f}%), {pr['device_kernels']} device "
          f"kernels")
    for r in pr["top"]:
        print(f"[{tag}]   {r['device_us']:10.1f} us {r['calls']:6d}x  "
              f"{r['name']}")
