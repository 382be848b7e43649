from repro_torch.distrib.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
