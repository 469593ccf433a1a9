"""Echo server harness — interactive LSP debugging (the port's copy of the
JAX package's ``apps/srunner.py``).

Flag parity with the reference dev harness (``srunner/srunner.go:15-23``):
``-port -rdrop -wdrop -elim -ems -wsize -v``.  Reads whatever any client
sends and echoes it straight back.
"""

from __future__ import annotations

import argparse
import sys

from .. import lsp, lspnet


def run_server(server: "lsp.Server", verbose: bool = False) -> None:
    while True:
        try:
            conn_id, payload = server.read()
        except lsp.ConnLostError as e:
            if verbose:
                print(f"connection {e.conn_id} lost", file=sys.stderr)
            continue
        except lsp.ConnClosedError:
            return
        if verbose:
            print(f"echo {len(payload)}B to {conn_id}", file=sys.stderr)
        try:
            server.write(conn_id, payload)
        except lsp.LspError:
            pass


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="LSP echo server")
    parser.add_argument("-port", type=int, default=9999)
    parser.add_argument("-rdrop", type=int, default=0, help="server read drop %%")
    parser.add_argument("-wdrop", type=int, default=0, help="server write drop %%")
    parser.add_argument("-elim", type=int, default=lsp.Params().epoch_limit)
    parser.add_argument("-ems", type=int, default=lsp.Params().epoch_millis)
    parser.add_argument("-wsize", type=int, default=lsp.Params().window_size)
    parser.add_argument("-v", action="store_true", help="debug logs")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)

    lspnet.enable_debug_logs(args.v)
    lspnet.set_server_read_drop_percent(args.rdrop)
    lspnet.set_server_write_drop_percent(args.wdrop)
    params = lsp.Params(
        epoch_limit=args.elim, epoch_millis=args.ems, window_size=args.wsize
    )
    server = lsp.Server(args.port, params)
    print(f"Echo server listening on port {args.port}", file=sys.stderr)
    try:
        run_server(server, args.v)
    finally:
        server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
