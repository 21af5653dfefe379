"""pcap dump CLI: run an experiment on the fidelity (oracle) engine and
capture every routed packet to a .pcap file (port of
``tools/pcapdump.py``: the same run gives the same bytes).

    python -m shadow1_tpu_torch.tools.pcapdump config.yaml out.pcap
        [--windows N] [--host NAME[:SOCK]]... [--sock N] [--edge VS:VD]...

The capture engine is the numpy oracle (``cpu_engine/``, on the host: it
sees every packet at routing time); for large configs bound the run with
--windows. --host narrows the capture to packets touching the named
endpoints — targets resolve exactly like the probe plane's --watch flag
(config host names, group[i] / group-i members, numeric ids, optional
:SOCK), so the pcap of a misbehaving flow and its probe stream point at the
same entity. --edge narrows it to packets crossing a topology edge (vertex
names or ids, directional) — the same edges the link-telemetry records key
on, so the pcap of a hot edge and its netreport row point at the same
object.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="shadow1_tpu_torch.tools.pcapdump")
    ap.add_argument("config")
    ap.add_argument("out")
    ap.add_argument("--windows", type=int, default=None)
    ap.add_argument("--snaplen", type=int, default=128)
    ap.add_argument("--host", action="append", default=None,
                    metavar="NAME[:SOCK]",
                    help="capture only packets whose src or dst matches "
                         "(repeatable; --watch target syntax — omit :SOCK "
                         "for every socket on the host)")
    ap.add_argument("--sock", type=int, default=None, metavar="N",
                    help="with --host entries that omit :SOCK, narrow them "
                         "to socket N")
    ap.add_argument("--edge", action="append", default=None,
                    metavar="VS:VD",
                    help="capture only packets crossing this topology edge "
                         "(repeatable; vertex names or numeric ids, "
                         "directional — the namespace link records use). "
                         "Combines with --host as OR")
    args = ap.parse_args(argv)

    from shadow1_tpu_torch.config.experiment import (
        WatchlistError,
        load_experiment,
        resolve_edges,
        resolve_watchlist,
    )
    from shadow1_tpu_torch.cpu_engine import CpuEngine
    from shadow1_tpu_torch.tools.pcap import FilteredPcap, PcapWriter

    if args.sock is not None and not args.host:
        ap.error("--sock narrows --host entries; give at least one --host")
    try:
        exp, params, _ = load_experiment(args.config)
        watchlist: tuple = ()
        if args.host:
            entries = [h if (":" in h or args.sock is None)
                       else f"{h}:{args.sock}" for h in args.host]
            watchlist = resolve_watchlist(entries, exp.dns,
                                          params.sockets_per_host)
        edges: tuple = ()
        if args.edge:
            edges = resolve_edges(args.edge, exp.vertex_names)
    except WatchlistError as e:
        ap.error(str(e))
    with FilteredPcap(PcapWriter(args.out, snaplen=args.snaplen),
                      watchlist, edges=edges,
                      host_vertex=exp.host_vertex) as w:
        eng = CpuEngine(exp, params, capture=w)
        m = eng.run(n_windows=args.windows)
        print(f"{w.n_packets} packets captured to {args.out}; metrics: {m}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
