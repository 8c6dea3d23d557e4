"""The plain reference of the localizer's measurement update.

Plain NumPy, SciPy and PyTorch: it imports no ``jax``, no
``mcl_3dl_tpu`` and nothing of ``mcl_3dl_tpu_torch``, and it takes
nothing that the program made.  It builds its own distance field from
the map points the benchmark made (``field``), its own scan cloud from
the raw points and odometry the benchmark sent (``cloud``), and works
out the per-particle scores of both LIDAR models (``models``) and the
filter's tail, the weights, the pose and its covariance (``filter``).

It follows the program step by step from the program's state before
each compared step: the particles, the output filters and the random
generator's state (the filter resamples, so two runs that drift apart
by one rounding never meet again).  The semantics are those of the
reference node at-wat/mcl_3dl v0.7.0 (src/mcl_3dl.cpp measure(),
lidar_measurement_model_likelihood.cpp, lidar_measurement_model_beam.cpp
with the kd-tree raycast) and of the port's stated departures: the
u8-coded truncated distance field in place of the kd-tree radius search,
and the sphere-traced raycast at tier 2.
"""
