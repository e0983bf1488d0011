"""The benchmark of btle_tpu_torch, the PyTorch and CUDA BLE sniffer.

One command runs one cell once (``python3 portbench/run.py --workload
NAME --seed N --seconds S --trace 0|1``). Everything a cell needs is
found by name: its configuration under ``configs/``, its traffic under
``traffic/``, its own settings and limits under ``workloads/``, each
metric's reader under ``metrics/``, the scene generators under
``scenes/`` and the systems under test under ``systems/``. The plain
reference that decides ``correct`` lives under ``reference/`` and
imports nothing of the program.
"""
