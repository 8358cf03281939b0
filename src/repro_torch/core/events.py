"""Simulated link timing: the ``LinkModel`` of the reference's
``repro/core/events.py``.

The discrete-event engine, the serverless runtime and the allocation
policies of that module come with the serverless and instance accounting
(ROADMAP.md, Queue 1, "Serverless and instance accounting").
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class LinkModel:
    """Wire time of one message on a simulated inter-peer link.

    The P2P cluster charges one ``transfer_s`` per publish and one per
    edge-respecting consume (``HostMailbox.download_time_s(link=...)`` adds
    the S3 round trip on top for indirected payloads), so with a sparse
    overlay graph a peer's per-step wire time is O(degree) rather than O(P).
    """

    bandwidth_bps: float = 1e9
    per_message_overhead_s: float = 0.0  # broker hop / TLS / framing

    def transfer_s(self, nbytes: int) -> float:
        return nbytes * 8.0 / self.bandwidth_bps + self.per_message_overhead_s
