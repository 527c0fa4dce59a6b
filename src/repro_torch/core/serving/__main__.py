"""``python -m repro_torch.core.serving`` — start a serving server from the
CLI."""

from . import main

if __name__ == "__main__":
    main()
