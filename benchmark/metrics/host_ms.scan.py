"""Host time of the engine's shell a scan, ms: the mean over the window's
scans of the ``push_cloud`` span less the ``_step`` span inside it (the
traced run ends ``_step``'s span when the device has finished the
step), so what is left is ``push_cloud``, ``_measure`` and
``_measure_base`` on the host: the accumulation, the base-frame
transform, the downsample, ``prepare_cloud`` and the publish."""


def read(trace):
    outer = trace["spans"].get("push_cloud", [])
    inner = trace["spans"].get("_step", [])
    if not outer or len(outer) != len(inner):
        return None
    return 1e3 * (sum(outer) - sum(inner)) / len(outer)
