"""``python -m mixedprecisionblockqr_tpu_torch``: the command-line
interface (``cli.py``)."""

from mixedprecisionblockqr_tpu_torch.cli import main

if __name__ == "__main__":
    import sys

    sys.exit(main())
