"""``repro_torch.wisdom`` — the operator entry point for wisdom stores.

``python -m repro_torch.wisdom <subcommand>`` manages the wisdom
directories the runtime reads (§4.4) and the fleet distribution layer
syncs (``repro_torch.distrib``). The implementation lives in
``repro_torch.distrib.cli``; this package only provides the memorable
module path (port of ``repro.wisdom``).
"""

from repro_torch.distrib.cli import build_parser, main

__all__ = ["build_parser", "main"]
