"""What the per-layer metrics' readers share: each reader in
``portbench/metrics/`` is one call of a function here on the run's
``harness.View``. A reader returns None where it finds nothing to read,
and raises ``harness.MetricError`` where the trace disagrees with the
shapes the cell implies.
"""

from __future__ import annotations

from portbench import counts
from portbench.harness import MetricError


def mfu(view, rate_metric: str):
    """The whole unit's share of the bf16 peak (%), from the window's
    untraced images/s and the model's FLOPs per image."""
    rate = view.window.get(rate_metric)
    if rate is None:
        return None
    return 100.0 * rate * view.layout["flops_per_image"] / view.peak_flops


def idle_share(view):
    """The device's idle share (%) of the device-only capture: 1 - the
    union of its kernel, memcpy and memset intervals over its wall time.
    (The full capture records host ops too, and its host, slowed by the
    profiler, sets the pace: its own idle share reads high.)"""
    if view.device is None or not view.device.ops:
        return None
    return 100.0 * (1.0 - view.device.busy_s / view.device.window_s)


def ms_per_unit(view, category: str, per_eval: bool = False):
    """Device ms of ``category`` (``trace.py``) per profiled unit, or per
    evaluation of the network."""
    seconds = view.trace.seconds(category)
    if seconds == 0.0:
        return None
    count = view.units * (view.layout["evals_per_unit"] if per_eval else 1)
    return 1e3 * seconds / count


def _share(view, entry: str, launches: int, bound_s: float):
    found = view.trace.ranges.get(entry, 0)
    seconds = view.trace.seconds("kernel:" + entry)
    if found == 0 or seconds == 0.0:
        return None
    if found != launches:
        raise MetricError(f"{entry}: {found} launches in {view.units} profiled units, the "
                          f"cell's shapes imply {launches}")
    return 100.0 * bound_s / seconds


def attention_roofline(view, entry: str, backward: bool):
    """The kernel's share of its roofline (%) over the profiled launches,
    where every attention layer of the cell launches it once per
    evaluation (``layout['attention']``: (N, L, H, hd, layers))."""
    count = counts.attention_bwd if backward else counts.attention_fwd
    evals = view.units * view.layout["evals_per_unit"]
    launches, bound = 0, 0.0
    for n, l, h, hd, layers in view.layout["attention"]:
        flops, nbytes = count(n, l, h, hd, view.layout["elem_bytes"])
        launches += layers * evals
        bound += layers * evals * counts.bound_s(flops, nbytes, view.peak_flops,
                                                 view.bandwidth)
    return _share(view, entry, launches, bound)


def adam_roofline(view):
    """The fused Adam + EMA update's share of its roofline (%): one launch
    over every parameter per unit."""
    ops, nbytes = counts.adam_ema(view.layout["adam_elements"],
                                  view.layout["adam_bytes_per_element"])
    bound = view.units * counts.bound_s(ops, nbytes, view.peak_flops, view.bandwidth)
    return _share(view, "fused_adam_ema", view.units, bound)
