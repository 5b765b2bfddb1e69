"""What the port's two profile tools share: the card's name and power limit,
and the device time of a ``torch.profiler`` trace summed by kernel."""

import subprocess


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def device_time(torch, prof, kind_of, steps, top_n):
    """Device time of every CUDA kernel in ``prof`` (a finished
    ``torch.profiler.profile`` over ``steps`` steps).  ``kind_of`` maps a
    kernel's name to a kind.  -> (busy ms per step, {kind: ms per step},
    the ``top_n`` kernels by time as dicts)."""
    per_name, per_kind = {}, {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = evt.time_range.elapsed_us()
        n, c = per_name.get(evt.name, (0.0, 0))
        per_name[evt.name] = (n + us, c + 1)
        k = kind_of(evt.name)
        per_kind[k] = per_kind.get(k, 0.0) + us
    busy_ms = sum(per_kind.values()) / 1e3 / steps
    by_kind = {k: v / 1e3 / steps
               for k, v in sorted(per_kind.items(), key=lambda kv: -kv[1])}
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:top_n]
    return busy_ms, by_kind, [
        {"name": name[:120], "ms_per_step": t / 1e3 / steps,
         "launches_per_step": c / steps} for name, (t, c) in top]
