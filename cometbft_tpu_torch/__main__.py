"""`python -m cometbft_tpu_torch`: the command line (cmd.py)."""

import sys

from cometbft_tpu_torch.cmd import main

if __name__ == "__main__":
    sys.exit(main())
