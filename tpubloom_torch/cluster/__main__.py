"""``python -m tpubloom_torch.cluster`` — cluster admin CLI (see rebalance.py)."""

import sys

from tpubloom_torch.cluster.rebalance import main

if __name__ == "__main__":
    sys.exit(main())
