"""The sketch kinds of the port: filter kinds whose storage is not a bloom
bit array, as in ``tpubloom.sketch``.

* :class:`~tpubloom_torch.sketch.cuckoo.CuckooFilter` — deletable
  membership from 16-bit fingerprints in buckets of 4 (``kind="cuckoo"``);
* :class:`~tpubloom_torch.sketch.cms.CountMinSketch` — frequency estimates
  from a ``[depth, width]`` counter grid (``kind="cms"``);
* :class:`~tpubloom_torch.sketch.cms.TopKSketch` — a count-min sketch with
  a heavy-hitter heap on the host (``kind="topk"``).

Each plugs into checkpoints and :func:`tpubloom_torch.interop.new_filter`
through :mod:`tpubloom_torch.sketch.registry`, which resolves the classes
lazily.
"""

from tpubloom_torch.sketch.registry import (  # noqa: F401
    KindSpec,
    blob_format,
    build,
    is_sketch,
    kind_of,
    replay_unsafe_insert,
    sketch_kinds,
    spec,
    supports_delete,
)
