"""Hopper counterparts of the TPU tools under ``tools/``: the development
probes, the card gates and benches, the BER and sensitivity sweeps, the
narrowband and multi-device benches and the vector generator.

Each module asks its TPU tool's question of the H100 and prints the same
kind of result lines; each has a ``run(device) -> dict`` and a ``main()``
behind ``python -m btle_tpu_torch.tools.<module>`` (with the tool's
flags), and runs nothing at import:

  dev_aagrp_repro      K9: the AA correlation and the strided-roll stack
  dev_aagrp_bisect     K8: K2 on GFSK lattices, K3 + K2, the AA stage alone
  dev_rollscale        K10: shifted per-row FMAs at 40, 80 and 160 rows
  dev_roll_experiment  K11: the im2col filterbank (K5) and the AA stage
  soak_fused           dense traffic with followed connections, byte-exact
  validate_fused       the fused scan against the plain one
  bench_live           the live loop against a producer paced at the wire
  bench_latency        verdict latency by block size
  ber_sweep            the full-depth BER sweep (BASELINE config 3)
  ber_2m_wideband      LE 2M against 1M decode counts through the channelizer
  dev_2m_cutoff        the LE 2M channel-filter cutoff sweep
  sensitivity          every shipped fused mode at the anchor SNR
  bench_narrowband     the single-channel scan over 1M-sample blocks
  bench_multichip      the sharded scan over a mesh sweep of ranks
  gen_test_vectors     per-stage golden vectors (``main(argv)`` only)

The probes' Mosaic variants (strided rolls, AA_GRP groupings, VMEM
scratch round trips, block-diagonal matmuls) collapse onto one Hopper
kernel per function: the probes run each variant's inputs, undone to the
function's plain layout, through that kernel.
"""
