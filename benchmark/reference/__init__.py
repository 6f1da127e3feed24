"""Plain references that decide a benchmark run's ``correct``.

Plain PyTorch and NumPy, written for this benchmark. They import nothing
of the package under test and nothing of JAX: they recompute, from the
inputs the benchmark draws, what the timed path should have produced.

The check finds them by the names a cell's files give:

* ``<measure>.py`` for a mix's ``measure`` (``pearson``, ``mi_kraskov``)
  has ``field(blocks, points, mix, voxels=None)``: the ``(R, V)`` or
  ``(R, K)`` float64 field of each reference point;
* ``<renderer>.py`` for a configuration's ``serve.renderer`` (``dvr``)
  has ``frame(field, cam, lut, domain, serve, layout_dtype)`` and the
  tuple ``SETTINGS`` of the renderer settings it draws.
"""
