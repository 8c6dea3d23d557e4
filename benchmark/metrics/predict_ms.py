"""Time a scan period spends in odometry and IMU calls, ms: the spans
around ``MCL3DL.odometry`` and ``MCL3DL.imu`` (each ended when the device
has finished its work), summed over the window and divided by its
scans."""


def read(trace):
    spans = trace["spans"]
    total = sum(spans.get("odometry", [])) + sum(spans.get("imu", []))
    if not trace["scans"] or not (spans.get("odometry") or spans.get("imu")):
        return None
    return 1e3 * total / trace["scans"]
