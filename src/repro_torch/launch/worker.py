"""Remote worker-pool entry point for the distributed (``host_remote``) tier.

    PYTHONPATH=src python -m repro_torch.launch.worker --listen 0.0.0.0:7001

Starts a ``core.net.worker_main`` pool: a TCP listener whose connections
each speak the shm slot protocol (length-prefixed frames, u64 sequence
numbers, EOS/ERR control, credit-window back-pressure, heartbeats).  The
worker has no code of its own — the first frame on every connection is a
pickled service callable (``TAG_FN`` handshake) shipped by the compiling
side, so one pool serves any ``compile(remote_workers=[...])`` program.
The pool runs numpy callables only and never touches the card; it serves
the port's farms (a lane carries one package's control records, see
``core/net.py``).

Two-"host" loopback run (both "hosts" on one machine, distinct ports):

    # terminal 1 — "host" A
    PYTHONPATH=src python -m repro_torch.launch.worker --listen 127.0.0.1:7001

    # terminal 2 — "host" B
    PYTHONPATH=src python -m repro_torch.launch.worker --listen 127.0.0.1:7002

    # terminal 3 — the program: farm workers live in the two pools
    PYTHONPATH=src python - <<'PY'
    import numpy as np
    from repro_torch.core import CompileConfig, farm, pipeline
    from repro_torch.launch.worker import demo_fn

    xs = list(np.random.default_rng(0).standard_normal((64, 32),
                                                       dtype=np.float32))
    r = pipeline(farm(demo_fn, n=2)).compile(config=CompileConfig(
        mode="remote",
        remote_workers=["127.0.0.1:7001", "127.0.0.1:7002"]))
    print(len(r.run(xs)))             # 64 squared rows, in input order
    PY

The callable ships pickled by reference, so it must be importable where
the pool runs: ``demo_fn`` is, and a function of a program's ``__main__``
resolves only in pools forked from that program
(:func:`~repro_torch.core.net.spawn_loopback_pool`).

``--listen host:0`` binds an ephemeral port and prints the bound address
on stdout (``listening <host>:<port> pid=<pid>``) so a launcher script can
scrape it.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..core import net


def demo_fn(x):
    """Default service used by ``--demo`` smoke runs and the CLI test:
    square numerics elementwise, echo anything else back."""
    if isinstance(x, np.ndarray) or isinstance(x, (int, float)):
        return x * x
    return x


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.worker",
        description="remote worker pool for host_remote farm stages")
    ap.add_argument("--listen", required=True, metavar="HOST:PORT",
                    help="bind address; PORT 0 picks an ephemeral port "
                         "(printed on stdout)")
    ap.add_argument("--slots", type=int, default=4,
                    help="accept backlog / expected concurrent lanes")
    ap.add_argument("--credit", type=int, default=32,
                    help="in-flight credit window granted per lane")
    ap.add_argument("--hb-interval", type=float, default=0.5,
                    help="heartbeat period in seconds")
    ap.add_argument("--max-conns", type=int, default=None,
                    help="serve this many connections then exit "
                         "(default: forever)")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress the 'listening' line")
    args = ap.parse_args(argv)

    host, port = net.parse_addr(args.listen)

    def announce(h, p):
        if not args.quiet:
            print(f"listening {h}:{p} pid={os.getpid()}", flush=True)

    net.worker_main(host, port,
                    slots=args.slots,
                    credit=args.credit,
                    hb_interval=args.hb_interval,
                    max_conns=args.max_conns,
                    announce=announce,
                    quiet=True)


if __name__ == "__main__":
    main()
