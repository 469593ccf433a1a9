"""Echo client harness — interactive LSP debugging (the port's copy of the
JAX package's ``apps/crunner.py``).

Flag parity with the reference dev harness (``crunner/crunner.go:16-25``):
``-host -port -rdrop -wdrop -elim -ems -wsize -v``.  Each whitespace token
on stdin is written to the server; the echo is read back and printed.
"""

from __future__ import annotations

import argparse
import sys

from .. import lsp, lspnet


def run_client(client: "lsp.Client") -> None:
    for line in sys.stdin:
        for token in line.split():
            client.write(token.encode("utf-8"))
            try:
                echo = client.read()
            except lsp.LspError:
                print("connection lost", file=sys.stderr)
                return
            print(f"[echo] {echo.decode('utf-8', 'replace')}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="LSP echo client")
    parser.add_argument("-host", default="localhost")
    parser.add_argument("-port", type=int, default=9999)
    parser.add_argument("-rdrop", type=int, default=0, help="client read drop %%")
    parser.add_argument("-wdrop", type=int, default=0, help="client write drop %%")
    parser.add_argument("-elim", type=int, default=lsp.Params().epoch_limit)
    parser.add_argument("-ems", type=int, default=lsp.Params().epoch_millis)
    parser.add_argument("-wsize", type=int, default=lsp.Params().window_size)
    parser.add_argument("-v", action="store_true", help="debug logs")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)

    lspnet.enable_debug_logs(args.v)
    lspnet.set_client_read_drop_percent(args.rdrop)
    lspnet.set_client_write_drop_percent(args.wdrop)
    params = lsp.Params(
        epoch_limit=args.elim, epoch_millis=args.ems, window_size=args.wsize
    )
    try:
        client = lsp.Client(args.host, args.port, params)
    except lsp.LspError as e:
        print("Failed to connect:", e, file=sys.stderr)
        return 1
    print(f"Connected (conn_id={client.conn_id()})", file=sys.stderr)
    try:
        run_client(client)
    finally:
        client.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
