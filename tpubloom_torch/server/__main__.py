"""``python -m tpubloom_torch.server [port] [checkpoint_dir] [--device cuda|cpu]
[--metrics-port N]``

The port's gRPC server (:func:`tpubloom_torch.server.service.main`).
``--metrics-port`` starts the background Prometheus exposition thread
(``GET /metrics``; :mod:`tpubloom_torch.obs`) next to the gRPC listener.
"""

from tpubloom_torch.server.service import main

if __name__ == "__main__":
    main()
