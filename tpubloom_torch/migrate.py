"""Flat -> blocked checkpoint migration: the port of ``tpubloom/migrate.py``.

The flat layout is the compatibility spec: its positions are the
reference gem's SETBIT/GETBIT Redis-bitmap positions, so a flat
checkpoint is readable by the reference's ``:ruby`` driver and vice
versa. The blocked layout is the throughput layout. A bloom filter cannot
enumerate its members, so migration needs the caller's key stream (the
system of record that fed the filter). :func:`migrate_checkpoint`

* streams the keys in bounded batches (constant memory at any corpus
  size),
* checks every batch against the flat filter as it goes: a key the flat
  filter does not hold means the stream is not the filter's source, and
  the migration fails (``strict=False`` counts such keys instead, for
  streams known to be a superset),
* inserts into a fresh blocked filter and writes its checkpoint.

Checkpoints of either package serve as source and destination (the blobs
cross; see :mod:`tpubloom_torch.checkpoint`).

CLI, which imports neither JAX nor ``tpubloom``::

    python -m tpubloom_torch.migrate --src DIR --key-name NAME --m M --k K --keys FILE

(newline-delimited keys, ``-`` for stdin; ``--device cpu`` runs the plain
PyTorch versions, else the filters live on the CUDA card).
"""

from __future__ import annotations

import itertools
from typing import Iterable, Optional

import numpy as np

from tpubloom_torch import checkpoint as ckpt
from tpubloom_torch.config import FilterConfig
from tpubloom_torch.filter import BlockedBloomFilter

DEFAULT_BATCH = 65536


def migrate_checkpoint(
    src_sink,
    keys: Iterable[bytes | str],
    *,
    dst_sink=None,
    src_config: FilterConfig,
    block_bits: int = 512,
    dst_key_name: Optional[str] = None,
    batch_size: int = DEFAULT_BATCH,
    strict: bool = True,
    device=None,
) -> dict:
    """Rebuild a flat filter's contents as a blocked filter, from the
    caller's key stream, and checkpoint the result.

    Args:
      src_sink: checkpoint sink holding the flat filter (newest seq used).
      keys: the key stream to re-insert — the filter's system of record.
      dst_sink: sink for the blocked checkpoint (defaults to ``src_sink``
        under ``dst_key_name``).
      src_config: the flat filter's config (identity-checked on restore).
      block_bits: blocked geometry for the destination (same m, k, seed).
      dst_key_name: destination namespace (default ``<key_name>.blocked``).
      batch_size: keys per device batch (bounded memory).
      strict: raise if a streamed key is absent from the flat filter
        (stream/filter mismatch); ``False`` records ``missing`` instead.
      device: where both filters live (the card unless given).

    Returns a summary dict: ``{"migrated", "missing", "seq", "dst_config"}``.
    """
    if src_config.block_bits or src_config.counting or src_config.shards > 1:
        raise ValueError("migration source must be a flat single-device config")
    src = ckpt.restore(src_config, src_sink, device=device)
    if src is None:
        raise ValueError(
            f"no checkpoint for {src_config.key_name!r} in the source sink"
        )
    dst_config = src_config.replace(
        block_bits=block_bits,
        block_hash="auto",
        key_name=dst_key_name or f"{src_config.key_name}.blocked",
    )
    dst = BlockedBloomFilter(dst_config, device)
    migrated = 0
    missing = 0
    it = iter(keys)
    while True:
        chunk = list(itertools.islice(it, batch_size))
        if not chunk:
            break
        present = src.include_batch(chunk)
        if not present.all():
            absent = int((~present).sum())
            if strict:
                i = int(np.argmin(present))
                raise ValueError(
                    f"key stream is not this filter's source: {absent} of "
                    f"{len(chunk)} keys in batch are absent from the flat "
                    f"filter (first: {chunk[i]!r}); pass strict=False only "
                    f"if the stream is a known superset"
                )
            missing += absent
            chunk = [kk for kk, p in zip(chunk, present) if p]
        if chunk:
            dst.insert_batch(chunk)
            migrated += len(chunk)
    sink = dst_sink if dst_sink is not None else src_sink
    seq = ckpt.save(dst, sink, extra={"migrated_from": src_config.key_name})
    return {
        "migrated": migrated,
        "missing": missing,
        "seq": seq,
        "dst_config": dst_config.to_dict(),
    }


def _main(argv=None) -> int:
    import argparse
    import json
    import sys

    ap = argparse.ArgumentParser(
        description="Migrate a flat (Redis-bitmap-compatible) tpubloom "
        "checkpoint to the blocked throughput layout by re-driving the "
        "key stream."
    )
    ap.add_argument("--src", required=True, help="source checkpoint directory")
    ap.add_argument("--dst", help="destination directory (default: --src)")
    ap.add_argument("--key-name", required=True)
    ap.add_argument("--dst-key-name")
    ap.add_argument("--m", type=int, required=True, help="flat filter m (bits)")
    ap.add_argument("--k", type=int, required=True)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--key-len", type=int, default=16)
    ap.add_argument("--block-bits", type=int, default=512)
    ap.add_argument("--batch-size", type=int, default=DEFAULT_BATCH)
    ap.add_argument(
        "--keys", required=True,
        help="newline-delimited key file ('-' = stdin); keys are used as "
        "raw bytes without the trailing newline",
    )
    ap.add_argument(
        "--lenient", action="store_true",
        help="skip (and count) keys absent from the flat filter instead of "
        "failing — only for streams known to be a superset",
    )
    ap.add_argument("--device", default=None,
                    help="torch device of the filters (default: the CUDA card)")
    args = ap.parse_args(argv)

    kw = {} if args.seed is None else {"seed": args.seed}
    src_config = FilterConfig(
        m=args.m, k=args.k, key_len=args.key_len, key_name=args.key_name, **kw
    )
    fh = sys.stdin.buffer if args.keys == "-" else open(args.keys, "rb")
    try:
        key_iter = (line.rstrip(b"\n") for line in fh)
        summary = migrate_checkpoint(
            ckpt.FileSink(args.src),
            key_iter,
            dst_sink=ckpt.FileSink(args.dst) if args.dst else None,
            src_config=src_config,
            block_bits=args.block_bits,
            dst_key_name=args.dst_key_name,
            batch_size=args.batch_size,
            strict=not args.lenient,
            device=args.device,
        )
    finally:
        if fh is not sys.stdin.buffer:
            fh.close()
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
