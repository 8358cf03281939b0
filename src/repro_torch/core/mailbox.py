"""RabbitMQ-analogue gradient mailboxes — paper §III-B.3.

The paper gives every peer a dedicated queue holding a single *persistent*
gradient message: a new gradient replaces the previous one ("latest wins"),
and consumers read without deleting. That is register semantics, which we
model two ways:

* :class:`HostMailbox` — host-level, used by the local P2P cluster. Also
  models the paper's 100 MB message cap (large payloads are "stored in S3
  and referenced by UUID": we count the indirection but deliver the payload
  either way).
* device-level — the ``async`` protocol's ring of register banks carried
  in the device train step's state (``core/exchange.py``).

A numpy copy of the reference's ``repro/core/mailbox.py``, its
trace-recorder hooks included.
"""
from __future__ import annotations

import uuid
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

MESSAGE_CAP_BYTES = 100 * 1024 * 1024  # Amazon MQ per-message limit
S3_ROUND_TRIP_S = 0.05  # fetch-by-UUID latency for indirected payloads


@dataclass
class Message:
    payload: Any
    publish_time: float
    epoch: int
    nbytes: int = 0  # wire size, charged to the consumer's simulated link
    via_s3: bool = False
    s3_uuid: Optional[str] = None


class _Registers:
    """One shard tag's register bank: struct-of-arrays over all P peers.

    Replaces the per-message dict-of-dataclasses storage — a publish is a
    handful of O(1) array writes, and the bank's footprint is preallocated
    columns (floats/ints/bools plus two object slots per peer) instead of
    a heap object per live message. :class:`Message` remains the *read*
    API: ``consume`` materializes one on demand.
    """

    __slots__ = (
        "payload", "publish_time", "epoch", "nbytes", "via_s3", "s3_uuid",
        "filled",
    )

    def __init__(self, num_peers: int):
        self.payload: List[Any] = [None] * num_peers
        self.publish_time = np.zeros(num_peers, dtype=np.float64)
        self.epoch = np.zeros(num_peers, dtype=np.int64)
        self.nbytes = np.zeros(num_peers, dtype=np.int64)
        self.via_s3 = np.zeros(num_peers, dtype=bool)
        self.s3_uuid: List[Optional[str]] = [None] * num_peers
        self.filled = np.zeros(num_peers, dtype=bool)


class HostMailbox:
    """One latest-wins register per (peer, shard) + a barrier queue.

    ``graph`` (a :class:`repro_torch.core.graph.PeerGraph`) restricts deliveries
    to overlay edges: a consumer identifying itself via ``consume(...,
    consumer=r)`` can only read queues of its graph neighbors — reads from
    non-neighbors return ``None`` and count in ``stats["blocked"]``. With
    no graph (or an anonymous consumer) the mailbox behaves like the
    paper's fully-connected broker.

    ``shard`` addresses sub-queues within a peer's mailbox — the sharded
    exchange publishes one *piece* message per shard owner plus one
    aggregated-shard broadcast, so a peer's queue space is a small fixed
    set of registers, not one monolithic gradient slot.

    Memory stays bounded by construction: publishes REPLACE the register
    (never append), so the live message count is at most ``num_peers x
    shard-tags`` regardless of how many epochs run. A publish that lands
    on a register already holding a message from the SAME epoch compacts
    it (latest wins within the (peer, epoch) cell) and counts in
    ``stats["compacted"]`` — the signal that producers are re-publishing
    faster than consumers drain.
    """

    def __init__(
        self, num_peers: int, *, s3_rtt_s: float = S3_ROUND_TRIP_S, graph=None,
        tracer=None,
    ):
        self.num_peers = num_peers
        self.s3_rtt_s = s3_rtt_s
        self.graph = graph
        # Optional repro_torch.analysis.trace.TraceRecorder: every publish/consume
        # is recorded for the happens-before race checker and the same-seed
        # determinism differ. None keeps the broker overhead-free.
        self.tracer = tracer
        # shard tag -> preallocated register bank over all peers;
        # shard=None is the classic whole-gradient register
        self._shards: Dict[Any, _Registers] = {}
        self._live = 0  # filled registers across all banks (O(1) count)
        # epoch -> (per-peer signalled flags, distinct-signal count):
        # signal/complete/reset are all O(1) in signals ever sent
        self._barrier: Dict[int, Tuple[np.ndarray, int]] = {}
        self.stats = {
            "publishes": 0, "consumes": 0, "s3_indirections": 0, "blocked": 0,
            "compacted": 0, "poisoned_publishes": 0, "rejected_nonfinite": 0,
        }
        # (consumer, producer) pairs actually delivered — lets tests assert
        # every delivery rode a graph edge, churn or not
        self.delivered_edges: set = set()

    # -- gradient queues ---------------------------------------------------
    def publish(
        self, peer: int, payload: Any, *, nbytes: int, time: float, epoch: int,
        shard: Any = None, poisoned: bool = False,
    ):
        if not 0 <= peer < self.num_peers:
            raise IndexError(f"peer {peer} out of range [0, {self.num_peers})")
        if poisoned:
            # Adversary-model bookkeeping only: the broker can't actually
            # tell; robust consumers must survive without this signal.
            self.stats["poisoned_publishes"] += 1
        via_s3 = nbytes > MESSAGE_CAP_BYTES
        regs = self._shards.get(shard)
        if regs is None:
            regs = self._shards[shard] = _Registers(self.num_peers)
        replaced_epoch: Optional[int] = None
        if regs.filled[peer]:
            replaced_epoch = int(regs.epoch[peer])
            if replaced_epoch == epoch:
                # latest-wins compaction within the (peer, epoch) cell
                self.stats["compacted"] += 1
        else:
            regs.filled[peer] = True
            self._live += 1
        # replaces the previous message (latest wins)
        regs.payload[peer] = payload
        regs.publish_time[peer] = time
        regs.epoch[peer] = epoch
        regs.nbytes[peer] = nbytes
        regs.via_s3[peer] = via_s3
        regs.s3_uuid[peer] = str(uuid.uuid4()) if via_s3 else None
        self.stats["publishes"] += 1
        if via_s3:
            self.stats["s3_indirections"] += 1
        if self.tracer is not None:
            self.tracer.record(
                "publish", time=time, actor=peer, epoch=epoch, shard=shard,
                nbytes=nbytes, replaced_epoch=replaced_epoch,
            )

    @property
    def live_messages(self) -> int:
        """Registers currently holding a message — bounded by peers x shards,
        NOT by epochs run (replacement, not append). O(1): maintained as a
        counter, never scanned."""
        return self._live

    def download_time_s(
        self, msg: Message, bandwidth_bps: Optional[float] = None, *, link=None
    ) -> float:
        """Receive-side wire time: payload transfer + the S3 fetch round trip
        for indirected (>100 MB) messages. Charged against the consumer's
        simulated link by the cluster / event engine. Pass either a raw
        ``bandwidth_bps`` or a :class:`repro_torch.core.events.LinkModel` (which
        adds its per-message overhead)."""
        if link is not None:
            t = link.transfer_s(msg.nbytes)
        else:
            t = msg.nbytes * 8.0 / bandwidth_bps
        if msg.via_s3:
            t += self.s3_rtt_s
        return t

    def consume(
        self,
        peer: int,
        *,
        at_time: Optional[float] = None,
        consumer: Optional[int] = None,
        shard: Any = None,
    ) -> Optional[Message]:
        """Read (without deleting) peer's latest message visible at `at_time`.

        ``consumer`` identifies the reading peer; when the mailbox carries
        an overlay graph, reads across non-edges are refused. ``shard``
        selects a shard-addressed register (see :meth:`publish`).
        """
        if not 0 <= peer < self.num_peers:
            raise IndexError(f"peer {peer} out of range [0, {self.num_peers})")
        if (
            self.graph is not None
            and consumer is not None
            and consumer != peer
            and not self.graph.has_edge(consumer, peer)
        ):
            self.stats["blocked"] += 1
            if self.tracer is not None:
                self.tracer.record(
                    "blocked", time=at_time, actor=consumer, peer=peer,
                    shard=shard,
                )
            return None
        regs = self._shards.get(shard)
        self.stats["consumes"] += 1
        if (
            regs is None
            or not regs.filled[peer]
            or (at_time is not None and regs.publish_time[peer] > at_time)
        ):
            # nothing in the register, or not yet published at this
            # simulated time — either way the consumer sees a miss
            if self.tracer is not None:
                self.tracer.record(
                    "miss", time=at_time, actor=consumer, peer=peer, shard=shard,
                )
            return None
        msg = Message(
            regs.payload[peer],
            float(regs.publish_time[peer]),
            int(regs.epoch[peer]),
            nbytes=int(regs.nbytes[peer]),
            via_s3=bool(regs.via_s3[peer]),
            s3_uuid=regs.s3_uuid[peer],
        )
        if consumer is not None:
            self.delivered_edges.add((consumer, peer))
        if self.tracer is not None:
            self.tracer.record(
                "consume", time=at_time, actor=consumer, peer=peer, shard=shard,
                epoch=msg.epoch, published=msg.publish_time,
            )
        return msg

    # -- synchronization barrier (paper §III-B.6) ---------------------------
    # Per-epoch signalled-flag arrays + distinct counts: every operation is
    # O(1), where the old list-of-(peer, epoch) storage rescanned all
    # signals ever sent on each complete/reset.
    def barrier_signal(self, peer: int, epoch: int):
        cell = self._barrier.get(epoch)
        if cell is None:
            cell = (np.zeros(self.num_peers, dtype=bool), 0)
        seen, count = cell
        if not seen[peer]:
            seen[peer] = True
            count += 1  # duplicate signals never over-count
        self._barrier[epoch] = (seen, count)

    def barrier_complete(self, epoch: int) -> bool:
        cell = self._barrier.get(epoch)
        return cell is not None and cell[1] == self.num_peers

    def barrier_reset(self, epoch: int):
        self._barrier.pop(epoch, None)
