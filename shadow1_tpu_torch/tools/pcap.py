"""pcap capture — write simulated packets as a standard .pcap file (port of
``tools/pcap.py``, a copy: the same packet records give the same bytes).

The reference can capture per-NIC traffic to pcap for wireshark-grade
debugging (src/main/utility/pcap-writer.c, per-interface capture flag).
Packets here carry no real bytes (payload is modeled as lengths), so the
writer synthesizes IPv4 + TCP/UDP headers from the packet record — host id
→ 10.x.y.z address, socket id → port, real seq/ack/flags/window — and pads
the payload with zeros (``snaplen`` caps what is written; ``orig_len``
keeps the true size, exactly how truncated captures work).

Capture runs on the CPU oracle (``CpuEngine(capture=...)``): the eager
engine sees every packet at routing time, which is the fidelity-debugging
context pcap serves; the batched engine's device loop intentionally never
surfaces per-packet records. ``tools/pcapdump.py`` is the command line
that runs the oracle with this writer as its capture hook.
"""

from __future__ import annotations

import struct

from shadow1_tpu_torch.consts import F_ACK, F_DGRAM, F_FIN, F_RST, F_SYN

LINKTYPE_RAW = 101  # raw IPv4


def _ip(host_id: int) -> bytes:
    return bytes([10, (host_id >> 16) & 0xFF, (host_id >> 8) & 0xFF, host_id & 0xFF])


class PcapWriter:
    """Streaming pcap writer; use as the CpuEngine ``capture`` callback."""

    def __init__(self, path: str, snaplen: int = 128):
        self.f = open(path, "wb")
        self.snaplen = snaplen
        self.n_packets = 0
        self.f.write(struct.pack(
            "<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0, snaplen, LINKTYPE_RAW
        ))

    def __call__(self, time_ns: int, src: int, dst: int, p: tuple,
                 dropped: bool) -> None:
        """CpuEngine capture hook: one routed packet (dropped = lost)."""
        if dropped:
            return  # what the wire delivered, like a receiver-side capture
        packed = int(p[1])
        ss, ds, flags = packed & 0xFF, (packed >> 8) & 0xFF, (packed >> 16) & 0xFF
        length = int(p[4])
        if flags & F_DGRAM:
            l4 = struct.pack(
                ">HHHH", 10000 + ss, 10000 + ds, min(8 + length, 0xFFFF), 0
            )
            proto = 17
        else:
            tcp_flags = (
                (0x02 if flags & F_SYN else 0)
                | (0x10 if flags & F_ACK else 0)
                | (0x01 if flags & F_FIN else 0)
                | (0x04 if flags & F_RST else 0)
            )
            l4 = struct.pack(
                ">HHIIBBHHH", 10000 + ss, 10000 + ds,
                int(p[2]) & 0xFFFFFFFF, int(p[3]) & 0xFFFFFFFF,
                5 << 4, tcp_flags, int(p[5]) & 0xFFFF, 0, 0,
            )
            proto = 6
        total = 20 + len(l4) + length
        ip = struct.pack(
            ">BBHHHBBH", 0x45, 0, min(total, 0xFFFF), self.n_packets & 0xFFFF,
            0, 64, proto, 0,
        ) + _ip(src) + _ip(dst)
        # Pad only what the snaplen keeps; orig_len carries the true size.
        head = ip + l4
        orig = len(head) + length
        incl = min(orig, self.snaplen)
        frame = (head + b"\x00" * max(incl - len(head), 0))[:incl]
        ts_sec, rem = divmod(int(time_ns), 10**9)
        self.f.write(struct.pack("<IIII", ts_sec, rem // 1000, incl, orig))
        self.f.write(frame)
        self.n_packets += 1

    def close(self) -> None:
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class FilteredPcap:
    """Watchlist filter in front of a PcapWriter (tools/pcapdump --host /
    --edge).

    ``watchlist`` is the probe plane's resolved (host, sock) tuple
    (config/experiment.resolve_watchlist — the same targets --watch
    accepts): a packet passes when its src OR dst endpoint matches an
    entry; sock == -1 entries match every socket on the host.

    ``edges`` is the link plane's resolved (src_vertex, dst_vertex) tuple
    (config/experiment.resolve_edges — the same edges link records key
    on), matched against the packet's attachment vertices via
    ``host_vertex``: the pcap of a hot edge and its link-record stream
    point at the same topology object. Directional, like link records.

    Both filters empty passes everything (filterless pcapdump unchanged);
    both given means EITHER may pass a packet (host-view OR edge-view).
    Drop-in for the CpuEngine ``capture`` hook — n_packets counts only
    what passed, like a capture filter on a real interface."""

    def __init__(self, writer: PcapWriter, watchlist: tuple = (),
                 edges: tuple = (), host_vertex=None):
        self.writer = writer
        self.watchlist = tuple(watchlist)
        self.edges = tuple(edges)
        if self.edges and host_vertex is None:
            raise ValueError("edge filtering needs the host_vertex map")
        self.host_vertex = host_vertex

    @property
    def n_packets(self) -> int:
        return self.writer.n_packets

    def _match(self, host: int, sock: int) -> bool:
        return any(h == host and (s < 0 or s == sock)
                   for h, s in self.watchlist)

    def _match_edge(self, src: int, dst: int) -> bool:
        vs = int(self.host_vertex[src])
        vd = int(self.host_vertex[dst])
        return (vs, vd) in self.edges

    def __call__(self, time_ns: int, src: int, dst: int, p: tuple,
                 dropped: bool) -> None:
        if self.watchlist or self.edges:
            packed = int(p[1])
            ss, ds = packed & 0xFF, (packed >> 8) & 0xFF
            ok = (self.watchlist
                  and (self._match(src, ss) or self._match(dst, ds)))
            ok = ok or (self.edges and self._match_edge(src, dst))
            if not ok:
                return
        self.writer(time_ns, src, dst, p, dropped)

    def close(self) -> None:
        self.writer.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
