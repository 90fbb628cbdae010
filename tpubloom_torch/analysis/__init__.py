"""Project-specific correctness tooling, aimed at the port.

Stdlib-only copies of ``tpubloom/analysis/*``, reading the port's own
registries and crediting the port's own harness:

* :mod:`tpubloom_torch.analysis.lint` — the static AST lint: no blocking
  calls under the registry/filter locks, quorum barriers outside every
  lock, op-log append ordered before ``notify_inserts``, no
  use-after-donate on device buffers, every mutating handler
  replay-cached (or argued safe), and the protocol/fault-point/metric/
  phase/span registries of ``tpubloom_torch/`` closed under
  cross-reference — including that every declared fault point is ARMED
  by a port test (``tests/test_torch_*.py``) or ``chip_smoke.py``.
* :mod:`tpubloom_torch.analysis.lock_order` — the declared lock-ORDER
  manifest a runtime acquisition graph is diffed against.
* :mod:`tpubloom_torch.utils.locks` — runtime lock-order and
  held-while-blocking analysis behind the ``TPUBLOOM_LOCK_CHECK`` env
  var; its exit reports feed the manifest diff.

``python -m tpubloom_torch.analysis [--json]`` is the unified entry point:
the full static lint of ``tpubloom_torch/`` plus the manifest diff over
collected ``lockcheck-*.json`` reports, one exit code (see
:mod:`tpubloom_torch.analysis.__main__`).
"""
