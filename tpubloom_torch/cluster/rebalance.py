"""Cluster administration CLI: ``python -m tpubloom_torch.cluster``.

Subcommands (all take ``--nodes a:port,b:port,...``):

* ``init`` — seed a fresh cluster: split the 16384 slots into
  contiguous even ranges over the nodes and push the full assignment to
  EVERY node (``ClusterSetSlot assign``) at ``--epoch`` (default 1).
* ``info`` — print each node's ``ClusterSlots`` view (epoch, ranges,
  in-flight migrations) as JSON.
* ``migrate --slot S --to ADDR`` — move one slot: the owner (resolved
  from the freshest map) drives ``MigrateSlot``.
* ``rebalance [--plan-only]`` — plan the minimal slot moves toward an
  even spread over ``--nodes`` and drive them sequentially (each move
  is one synchronous ``MigrateSlot``); ``--plan-only`` prints the plan
  without moving anything. New (empty) nodes are first pushed the
  current map so their ownership checks answer ``MOVED`` instead of
  ``CLUSTERDOWN``.

Every move is the crash-safe migration of
:mod:`tpubloom_torch.cluster.migrate`: re-running an interrupted ``rebalance``
resumes via snapshot probes + op-log tails, never double-applies.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import grpc

from tpubloom_torch.cluster import slots as slots_mod
from tpubloom_torch.server import protocol

_CHANNEL_OPTIONS = list(protocol.CHANNEL_OPTIONS)


def node_call(addr: str, method: str, req: dict, timeout: float = 600.0) -> dict:
    channel = grpc.insecure_channel(addr, options=_CHANNEL_OPTIONS)
    try:
        raw = channel.unary_unary(
            protocol.method_path(method),
            request_serializer=lambda b: b,
            response_deserializer=lambda b: b,
        )(protocol.encode(req), timeout=timeout)
        return protocol.check(protocol.decode(raw))
    finally:
        channel.close()


def even_ranges(nodes: list) -> list:
    """Contiguous even split of the keyspace: ``[[start, end, addr],
    ...]`` (the same shape Redis Cluster's create does)."""
    n = len(nodes)
    per = slots_mod.NUM_SLOTS // n
    out = []
    start = 0
    for i, addr in enumerate(nodes):
        end = slots_mod.NUM_SLOTS - 1 if i == n - 1 else start + per - 1
        out.append([start, end, addr])
        start = end + 1
    return out


def freshest_map(nodes: list) -> Optional[dict]:
    """The highest-epoch ``ClusterSlots`` answer across the nodes."""
    best = None
    for addr in nodes:
        try:
            resp = node_call(addr, "ClusterSlots", {}, timeout=5.0)
        except (grpc.RpcError, protocol.BloomServiceError):
            continue
        if not resp.get("enabled"):
            continue
        if best is None or int(resp.get("epoch") or 0) > int(best["epoch"]):
            best = resp
    return best


def push_assignment(nodes: list, ranges: list, epoch: int) -> list:
    """``ClusterSetSlot assign`` to every node; returns the nodes that
    could not be reached (the caller decides whether that is fatal)."""
    unreachable = []
    for addr in nodes:
        try:
            node_call(
                addr, "ClusterSetSlot",
                {"assign": ranges, "epoch": epoch}, timeout=10.0,
            )
        except (grpc.RpcError, protocol.BloomServiceError):
            unreachable.append(addr)
    return unreachable


def plan_moves(owners: dict, nodes: list) -> list:
    """Minimal-ish move plan toward an even spread of the ASSIGNED
    slots: ``[(slot, from, to), ...]``. Slots owned by nodes OUTSIDE
    the target set all move; then excess slots flow from over- to
    under-target nodes."""
    total = len(owners)
    target_floor = total // len(nodes)
    remainder = total - target_floor * len(nodes)
    targets = {
        addr: target_floor + (1 if i < remainder else 0)
        for i, addr in enumerate(nodes)
    }
    held: dict = {addr: [] for addr in nodes}
    stray: list = []
    for slot in sorted(owners):
        addr = owners[slot]
        if addr in held:
            held[addr].append(slot)
        else:
            stray.append((slot, addr))
    moves: list = []
    donors: list = []
    for addr in nodes:
        excess = len(held[addr]) - targets[addr]
        if excess > 0:
            donors.extend((held[addr].pop(), addr) for _ in range(excess))
    pool = stray + donors
    for addr in nodes:
        while len(held[addr]) < targets[addr] and pool:
            slot, src = pool.pop()
            moves.append((slot, src, addr))
            held[addr].append(slot)
    return moves


def _cmd_init(args) -> int:
    ranges = even_ranges(args.nodes)
    missed = push_assignment(args.nodes, ranges, args.epoch)
    print(json.dumps({"assigned": ranges, "epoch": args.epoch,
                      "unreachable": missed}))
    return 1 if missed else 0


def _cmd_info(args) -> int:
    views = {}
    for addr in args.nodes:
        try:
            views[addr] = node_call(addr, "ClusterSlots", {}, timeout=5.0)
        except (grpc.RpcError, protocol.BloomServiceError) as e:
            views[addr] = {"ok": False, "error": str(e)}
    print(json.dumps(views, indent=2))
    return 0


def _cmd_migrate(args) -> int:
    view = freshest_map(args.nodes)
    if view is None:
        print("no node answered ClusterSlots; is --cluster enabled?",
              file=sys.stderr)
        return 1
    owners = slots_mod.expand_ranges(view["ranges"])
    src = owners.get(args.slot)
    if src is None:
        print(f"slot {args.slot} is unassigned", file=sys.stderr)
        return 1
    if src == args.to:
        print(json.dumps({"ok": True, "noop": True, "slot": args.slot}))
        return 0
    resp = node_call(src, "MigrateSlot", {"slot": args.slot, "target": args.to})
    print(json.dumps(resp))
    return 0


def _cmd_rebalance(args) -> int:
    view = freshest_map(args.nodes)
    if view is None:
        print("no node answered ClusterSlots; run `init` first?",
              file=sys.stderr)
        return 1
    owners = slots_mod.expand_ranges(view["ranges"])
    epoch = int(view.get("epoch") or 0)
    if len(owners) < slots_mod.NUM_SLOTS:
        print(
            f"warning: only {len(owners)}/{slots_mod.NUM_SLOTS} slots "
            f"assigned; unassigned slots stay CLUSTERDOWN",
            file=sys.stderr,
        )
    # every node (incl. fresh ones) needs the current map before moves
    # start, or its ownership checks answer CLUSTERDOWN mid-rebalance
    push_assignment(args.nodes, slots_mod.ranges_of(owners), epoch)
    moves = plan_moves(owners, args.nodes)
    print(json.dumps({"planned_moves": len(moves),
                      "moves": [list(m) for m in moves[:32]]}))
    if args.plan_only:
        return 0
    done = failed = 0
    for slot, src, dst in moves:
        try:
            node_call(src, "MigrateSlot", {"slot": slot, "target": dst})
            done += 1
        except (grpc.RpcError, protocol.BloomServiceError) as e:
            failed += 1
            print(f"move slot {slot} {src} -> {dst} failed: {e}",
                  file=sys.stderr)
    print(json.dumps({"moved": done, "failed": failed}))
    return 1 if failed else 0


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m tpubloom_torch.cluster",
        description="tpubloom cluster admin (Redis Cluster parity)",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    def add_nodes(p):
        p.add_argument(
            "--nodes", required=True,
            type=lambda s: [a for a in s.split(",") if a],
            help="comma-separated cluster node addresses (host:port)",
        )

    p = sub.add_parser("init", help="seed an even slot assignment")
    add_nodes(p)
    p.add_argument("--epoch", type=int, default=1)
    p.set_defaults(fn=_cmd_init)

    p = sub.add_parser("info", help="print every node's slot-map view")
    add_nodes(p)
    p.set_defaults(fn=_cmd_info)

    p = sub.add_parser("migrate", help="move one slot to a target node")
    add_nodes(p)
    p.add_argument("--slot", type=int, required=True)
    p.add_argument("--to", required=True, metavar="HOST:PORT")
    p.set_defaults(fn=_cmd_migrate)

    p = sub.add_parser("rebalance", help="plan + drive moves to an even spread")
    add_nodes(p)
    p.add_argument("--plan-only", action="store_true")
    p.set_defaults(fn=_cmd_rebalance)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
