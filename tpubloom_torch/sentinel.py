"""``python -m tpubloom_torch.sentinel --watch host:port --peers ...``

Thin entry point for the failover watcher; the implementation lives in
:mod:`tpubloom_torch.ha.sentinel` (quorum votes, most-caught-up promotion,
survivor re-pointing, stale-primary fencing).
"""

from tpubloom_torch.ha.sentinel import Sentinel, main

__all__ = ["Sentinel", "main"]

if __name__ == "__main__":
    main()
