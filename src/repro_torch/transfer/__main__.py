"""Entry point: ``python -m repro_torch.transfer``."""

from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
