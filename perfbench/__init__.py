"""The benchmark of the PyTorch and CUDA port (``future_urban_scene_generation_tpu_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` on the machine it is started on. Everything that
belongs to one configuration, cell, entry kind or metric sits in a file of its own,
found by name: ``configs/<config>.json``, ``cells/<cell>.json``,
``entries/<kind>.py``, ``metrics/<metric>.py``. The yardstick (traffic, roofline
reckonings, the plain reference and the comparison that decides ``correct``) lives
here too and imports nothing of the program.
"""
