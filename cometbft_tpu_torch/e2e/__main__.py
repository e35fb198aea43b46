"""CLI for the manifest generator + config-matrix runner (see package
docstring; reference: test/e2e/generator/main.go + runner/main.go). The
port's copy of cometbft_tpu/e2e/__main__.py, with a port-only
`--crypto_backend gpu|cpu` on run, ci and fleet (default: the card)."""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

from cometbft_tpu_torch.e2e.generator import generate_manifests
from cometbft_tpu_torch.e2e.manifest import Manifest
from cometbft_tpu_torch.e2e.runner import RunError, run_manifest


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="cometbft_tpu_torch.e2e")
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate", help="write random manifest TOMLs")
    g.add_argument("--seed", type=int, default=int(time.time()))
    g.add_argument("--count", type=int, default=5)
    g.add_argument("--dir", default="e2e-manifests")

    r = sub.add_parser("run", help="run one manifest")
    r.add_argument("--manifest", required=True)
    r.add_argument("--dir", default="")
    r.add_argument("--base-port", type=int, default=29000)

    c = sub.add_parser("ci", help="generate + run a sampled matrix")
    c.add_argument("--seed", type=int, default=int(time.time()))
    c.add_argument("--count", type=int, default=5)
    c.add_argument("--base-port", type=int, default=29000)

    f = sub.add_parser(
        "fleet", help="run one deliberate fleet-scale testnet "
                      "(50-100 nodes; gated by the resource guard)")
    f.add_argument("--nodes", type=int, default=50)
    f.add_argument("--topology", default="regional",
                   choices=("full", "hub", "regional"))
    f.add_argument("--regions", type=int, default=4)
    f.add_argument("--link-profile", default=None,
                   choices=("", "wan", "lossy-wan"),
                   help="cross-region link profile (default: wan for the "
                        "regional topology, clean wire otherwise)")
    f.add_argument("--perturb", default="regional-partition:1,churn-storm:30",
                   help="comma-separated net perturbations ('' for none)")
    f.add_argument("--no-summaries", action="store_true",
                   help="full-gossip control arm (reconciliation off)")
    f.add_argument("--dir", default="")
    # span must end below the kernel ephemeral range (guard enforces)
    f.add_argument("--base-port", type=int, default=10000)

    for sp in (r, c, f):
        # port-only: where every node verifies (default: the card)
        sp.add_argument("--crypto_backend", "--crypto.backend", dest="crypto_backend",
                        default="gpu", choices=["gpu", "cpu"])

    ns = p.parse_args(argv)
    if ns.cmd == "generate":
        os.makedirs(ns.dir, exist_ok=True)
        for m in generate_manifests(ns.seed, ns.count):
            path = os.path.join(ns.dir, f"{m.name}.toml")
            with open(path, "w") as f:
                f.write(m.to_toml())
            print(path)
        return 0
    if ns.cmd == "run":
        with open(ns.manifest, "rb") as f:
            m = Manifest.from_toml(f.read().decode())
        out = ns.dir or tempfile.mkdtemp(prefix=f"e2e-{m.name}-")
        try:
            run_manifest(m, out, base_port=ns.base_port, backend=ns.crypto_backend)
        except RunError as e:
            print(f"FAIL {m.name}: {e}", file=sys.stderr)
            return 1
        return 0
    if ns.cmd == "fleet":
        from cometbft_tpu_torch.e2e.generator import generate_fleet_manifest

        profile = ns.link_profile
        if profile is None:
            profile = "wan" if ns.topology == "regional" else ""
        m = generate_fleet_manifest(
            ns.nodes, topology=ns.topology, regions=ns.regions,
            link_profile=profile,
            net_perturb=tuple(x for x in ns.perturb.split(",") if x),
            vote_summaries=not ns.no_summaries)
        out = ns.dir or tempfile.mkdtemp(prefix=f"e2e-{m.name}-")
        try:
            run_manifest(m, out, base_port=ns.base_port, backend=ns.crypto_backend)
        except RunError as e:
            print(f"FAIL {m.name}: {e}", file=sys.stderr)
            print(f"(forensics: {os.path.join(out, 'net_report.json')})",
                  file=sys.stderr)
            return 1
        print(f"fleet report: {os.path.join(out, 'net_report.json')}")
        return 0
    # ci
    failures = 0
    for i, m in enumerate(generate_manifests(ns.seed, ns.count)):
        out = tempfile.mkdtemp(prefix=f"e2e-{m.name}-")
        print(f"=== [{i + 1}/{ns.count}] {m.name} "
              f"({len(m.nodes)} nodes, seed {ns.seed}) ===")
        try:
            run_manifest(m, out, base_port=ns.base_port + i * 100,
                         backend=ns.crypto_backend)
        except RunError as e:
            failures += 1
            print(f"FAIL {m.name}: {e}", file=sys.stderr)
    print(f"ci: {ns.count - failures}/{ns.count} manifests green")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
