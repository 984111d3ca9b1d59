"""The benchmark's plain reference: frozen copies of the port's plain code at commit
a2138eb (``future_urban_scene_generation_tpu_torch``: spec, geometry, models, ops,
render, pipeline and the mesh utilities), with every kernel of the port replaced by its
plain version (K1: the chunked argmin raster; K2: the stem as ``F.conv2d`` on the
concatenated, reflect-padded input; K3: ``F.conv2d``), PnP's Jacobian a plain
``jacfwd``, no int8 tier, and the trainer's Adam written out. Each module's header
names its source and its departures. It imports neither JAX nor the JAX package nor
the port, and takes nothing the port made: it rebuilds the CAD bank, the batches and
the train state from the benchmark's inputs and the seeded weights.
"""
