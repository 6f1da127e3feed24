"""What an interaction moves, one file a kind, found by a mix's
``interaction``. Each ``<kind>.py`` has

* ``window(mix, grid_xyz, gen)``: the window's endless interactions;
* ``warmup(mix, grid_xyz, gen, count)``: ``count`` interactions of the
  shapes the window meets, for the set-up;

where ``gen`` is the seed's ``numpy.random.Generator`` for the stream,
and an interaction is a dict: ``{"point": (x, y, z)}`` or
``{"camera": camera}`` (:func:`benchmark.traffic.camera`).
"""
