"""Host time of odometry and IMU a scan period, ms, from the program's
own spans: the window's ``odometry`` and ``imu`` requests
(``program_spans.window``), each from the call to its return with no
wait for the device, summed and divided by the window's scans.  Against
``predict_ms`` (the same calls, each ended after the device finished),
it tells the host's launch cost from the device's time."""

from benchmark import program_spans


def read(trace):
    w = program_spans.window(trace)
    if w is None:
        return None
    recs, scans = w
    roots = [r for r in recs if r.parent == 0]
    if not any(r.name in ("odometry", "imu") for r in roots):
        return None
    return 1e3 * program_spans.seconds(roots, ("odometry", "imu")) / scans
