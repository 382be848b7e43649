"""Entry point: ``python -m repro_torch.tunebench``."""

from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
