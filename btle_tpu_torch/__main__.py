"""Module entry point: ``python -m btle_tpu_torch <subcommand> ...``.

The counterpart of ``python -m btle_tpu``: the full CLI lives in
btle_tpu_torch.cli.app; this shim makes the package itself invocable.
"""

from .cli.app import main

raise SystemExit(main())
