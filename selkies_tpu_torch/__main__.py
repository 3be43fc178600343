"""Console entry point: ``selkies-tpu-torch`` / ``python -m selkies_tpu_torch``."""

from __future__ import annotations

import sys


def main() -> int:
    from .server.main import run
    from .settings import get_settings

    return run(get_settings(sys.argv[1:]))


if __name__ == "__main__":
    raise SystemExit(main())
