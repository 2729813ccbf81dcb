"""What the per-layer metrics' readers share: a mean per job in
milliseconds, and a kernel's share of its roofline bound in the trace.
Where what a metric reads is not there, its reader returns None and the
metric is left out: a renamed span or a probe that saw nothing never reads
as 0."""

from __future__ import annotations

from benchmark import devtrace


def per_job_ms(ctx, seconds_of):
    """Mean over the window's completed jobs of ``seconds_of(job)``, in ms;
    None when no job completed or a job has no reading (None)."""
    values = [seconds_of(j) for j in ctx["jobs"]]
    if not values or any(v is None for v in values):
        return None
    return 1e3 * sum(values) / len(values)


def timing(*keys):
    """``seconds_of`` summing ``align_and_count``'s ``timings`` ``keys``;
    None for a job whose ``timings`` lack one of them."""
    def seconds_of(job):
        if not all(k in job.timings for k in keys):
            return None
        return sum(job.timings[k] for k in keys)

    return seconds_of


def roofline_pct(ctx, kernels):
    """100 x the least time of the problems handed to ``kernels`` (the
    larger of operations over the int32 peak and bytes over the memory
    rate, per kernel) over their summed device time in the trace. None
    without a card trace, without time of these kernels, or where a kernel
    has device time but its probe counted no work."""
    tr = ctx["trace"]
    if tr is None or not ctx["peak_ops"]:
        return None
    spent_us = dict.fromkeys(kernels, 0.0)
    for name, (tot, _) in tr["kernels"].items():
        k = devtrace.kernel_of(name)
        if k in spent_us:
            spent_us[k] += tot
    if sum(spent_us.values()) <= 0:
        return None
    if any(spent_us[k] > 0 and not any(ctx["work"][k]) for k in kernels):
        return None
    least_s = sum(devtrace.bound_s(*ctx["work"][k], ctx["peak_ops"])
                  for k in kernels)
    return 100.0 * least_s / (sum(spent_us.values()) / 1e6)
