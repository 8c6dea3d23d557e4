"""Share of the window's measurement steps that replayed both CUDA
graphs (``step_graph`` route ``graph``), %: the program's
``step_routes`` counter over the window."""


def read(trace):
    routes = trace["routes"]
    total = sum(routes.values())
    if not total:
        return None
    return 100.0 * routes.get("graph", 0) / total
