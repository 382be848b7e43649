"""Entry point for ``python -m repro_torch.sandbox``."""

from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
