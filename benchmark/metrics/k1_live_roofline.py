"""Kernel K1's share of its roofline at the live tables it was given, %:
the least time of one launch (``roofline/k1.py``'s ``count``) at the
mean live (point, bin) tables a launch over the run, the program's
counter ``grouped_like_score.live_tables`` over its ``launches``,
against K1's mean device time a launch in the profiled slice.  Nothing
where the program has no such counter or K1 did not run."""

from benchmark import harness


def read(trace):
    prof = trace["prof"]
    if prof is None:
        return None
    try:
        from mcl_3dl_tpu_torch.ops import grouped
    except ImportError:
        return None
    fn = grouped.grouped_like_score
    live = getattr(fn, "live_tables", None)
    if live is None or not fn.launches:
        return None
    k1 = harness.roofline("k1")
    times = [t for name, ts in prof["kernels"].items()
             if k1.KERNEL in name for t in ts]
    if not times:
        return None
    s = trace["shapes"]
    tables = int(live) / fn.launches
    least = harness.bound_s(*k1.count(s["particles"], s["like_points"],
                                      s["bins"], round(tables)))
    return 100.0 * least / (sum(times) / len(times))
