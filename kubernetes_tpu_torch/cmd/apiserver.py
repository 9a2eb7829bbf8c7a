"""cmd/kube-apiserver (app/server.go:90 NewAPIServerCommand, :157 Run):
the standalone launchable API server binary; an own copy of
``kubernetes_tpu/cmd/apiserver.py``. It runs no device work.

    python -m kubernetes_tpu_torch.cmd.apiserver --port 6443 \
        --wal /var/lib/ktpu/store.wal \
        --token-auth-file tokens.csv --authorization-mode Node,RBAC

Assembles the same pieces the embedded form uses (serve_api over a
``Store`` with the admission chain), adds the binary-level concerns:
durable storage (WAL restore + attach), authn from the reference's static
token file format (token,user,uid[,"group1,group2"] per line),
the Node/RBAC authorizer chain, and healthz/readyz on the same mux via the
store-backed handler. SIGTERM drains and snapshots."""

from __future__ import annotations

import argparse
import csv
import signal
import sys
import threading


def build_auth(args, store):
    from ..apiserver.auth import (
        AuthConfig,
        Authenticator,
        FlowController,
        NodeAuthorizer,
        RBACAuthorizer,
        UserInfo,
    )

    tokens = {}
    if args.token_auth_file:
        # the reference static token file (--token-auth-file,
        # staging/src/k8s.io/apiserver/pkg/authentication/token/tokenfile):
        # token,user,uid[,"group1,group2"] per line — token FIRST
        with open(args.token_auth_file) as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = next(csv.reader([line]))
                if len(parts) < 3:
                    raise SystemExit(
                        f"{args.token_auth_file}:{lineno}: token file lines "
                        "are token,user,uid[,\"group1,group2\"]")
                token, user = parts[0].strip(), parts[1].strip()
                groups = tuple(g.strip() for g in parts[3].split(",")
                               if g.strip()) if len(parts) > 3 else ()
                tokens[token] = UserInfo(user, groups)
    authenticator = Authenticator(tokens=tokens) if tokens else None
    modes = [m.strip() for m in (args.authorization_mode or "").split(",") if m.strip()]
    unknown = [m for m in modes if m not in ("Node", "RBAC")]
    if unknown:
        # fail startup like the reference binary — a typo'd mode silently
        # ignored would leave the server wide open behind an authz banner
        raise SystemExit(
            f"--authorization-mode: unknown mode(s) {unknown}; supported: Node, RBAC")
    authorizer = None
    if "RBAC" in modes:
        authorizer = RBACAuthorizer(store)
    if "Node" in modes:
        authorizer = NodeAuthorizer(store, delegate=authorizer)
    flow = FlowController() if args.enable_priority_and_fairness else None
    if authenticator is None and authorizer is None and flow is None:
        return None
    return AuthConfig(authenticator=authenticator, authorizer=authorizer,
                      flow=flow)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="kube-apiserver")
    parser.add_argument("--port", type=int, default=6443)
    parser.add_argument("--wal", default="",
                        help="durable store path (restore + append; empty = memory-only)")
    parser.add_argument("--token-auth-file", default="")
    parser.add_argument("--authorization-mode", default="",
                        help='comma list: "Node", "RBAC" (empty = open)')
    parser.add_argument("--enable-priority-and-fairness", action="store_true")
    parser.add_argument("--snapshot-on-exit",
                        action=argparse.BooleanOptionalAction, default=True,
                        help="compact the WAL into a snapshot on SIGTERM "
                             "(--no-snapshot-on-exit for fast shutdown)")
    args = parser.parse_args(argv)

    from ..apiserver.http import serve_api, shutdown_api
    from ..apiserver.store import Store
    from ..apiserver.wal import restore

    if args.wal:
        store = restore(args.wal)  # also re-attaches a compacted WAL
        print(f"restored {sum(len(store._kind_map(k)) for k in store.KINDS)} "
              f"objects from {args.wal}", file=sys.stderr)
    else:
        store = Store()

    auth = build_auth(args, store)
    server, port = serve_api(store, port=args.port, auth=auth)
    print(f"kube-apiserver listening on 127.0.0.1:{port} "
          f"(authz={args.authorization_mode or 'open'}, "
          f"wal={'on' if args.wal else 'off'})", file=sys.stderr)

    stop = threading.Event()

    def _term(_sig, _frm):
        stop.set()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    try:
        while not stop.wait(0.5):
            pass
    finally:
        if args.wal and args.snapshot_on_exit and store._wal is not None:
            store._wal.snapshot(store)
        shutdown_api(server)
    return 0


if __name__ == "__main__":
    sys.exit(main())
