"""Hopper counterparts of the TPU development probes under ``tools/``.

Each probe module asks its TPU tool's question of the H100 and prints
the same kind of result lines; each has a ``run(device) -> dict`` and a
``main()`` behind ``python -m btle_tpu_torch.tools.<probe>``, and runs
nothing at import:

  dev_aagrp_repro      K9: the AA correlation and the strided-roll stack
  dev_aagrp_bisect     K8: K2 on GFSK lattices, K3 + K2, the AA stage alone
  dev_rollscale        K10: shifted per-row FMAs at 40, 80 and 160 rows
  dev_roll_experiment  K11: the im2col filterbank (K5) and the AA stage

The TPU tools' Mosaic variants (strided rolls, AA_GRP groupings, VMEM
scratch round trips, block-diagonal matmuls) collapse onto one Hopper
kernel per function: the probes run each variant's inputs, undone to the
function's plain layout, through that kernel.
"""
