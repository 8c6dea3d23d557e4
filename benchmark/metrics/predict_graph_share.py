"""Share of the window's odometry predicts and IMU weighs that replayed
their CUDA graph, %: the window's ``odometry.predict`` and ``imu.weigh``
spans that hold the program's ``predict.graph`` counter, over all of
them.  Nothing where no such span holds a ``predict.*`` route counter (a
program without the odometry and IMU graphs, or no records)."""

from benchmark import program_spans

CALLS = ("odometry.predict", "imu.weigh")


def read(trace):
    w = program_spans.window(trace)
    if w is None:
        return None
    recs = w[0]
    calls = {r.id for r in recs if r.value is None and r.name in CALLS}
    routes = [r for r in recs if r.value is not None
              and r.name.startswith("predict.") and r.parent in calls]
    if not routes:
        return None
    graphed = {r.parent for r in routes if r.name == "predict.graph"}
    return 100.0 * len(graphed) / len(calls)
