"""The port's e2e package (e2e/manifest.py, e2e/generator.py, e2e/runner.py,
e2e/__main__.py) against the JAX package's:

- for the same seed, generate_manifests and generate_fleet_manifest write
  the same TOML, and the CLI's `generate` the same files;
- Manifest.validate (over the port's libs/fail.SITES and
  libs/chaos.MESH_CHAOS_DEVICES) accepts every perturbation and refuses
  what the reference refuses, with the same message;
- setup writes the reference's homes, but for the crypto.backend line
  (ROADMAP Queue 3 entry 24: "gpu" by default, the reference's "cpu") and,
  on "gpu", consensus.batch_vote_verification on;
- one run_manifest of a one-node manifest with `kill`, as OS processes on
  the "cpu" backend: the node is killed, respawned and catches up, its log
  lands in its home, and the net report is written.
"""

from __future__ import annotations

import json
import os
import shutil

import pytest

from cometbft_tpu.e2e import __main__ as jmain
from cometbft_tpu.e2e import generator as jgen
from cometbft_tpu.e2e import manifest as jman
from cometbft_tpu.e2e import runner as jrun
from cometbft_tpu.utils import cmttime as jtime
from cometbft_tpu_torch.e2e import __main__ as tmain
from cometbft_tpu_torch.e2e import generator as tgen
from cometbft_tpu_torch.e2e import manifest as tman
from cometbft_tpu_torch.e2e import runner as trun
from cometbft_tpu_torch.utils import cmttime as ttime


@pytest.mark.parametrize("seed", [0, 1, 7, 2024, 99991])
def test_generated_manifests_are_the_reference_s(seed):
    t = [m.to_toml() for m in tgen.generate_manifests(seed, 12)]
    assert t == [m.to_toml() for m in jgen.generate_manifests(seed, 12)]
    for text in t:
        assert tman.Manifest.from_toml(text).to_toml() == text


FLEETS = [dict(n_nodes=50), dict(n_nodes=8, topology="hub", hubs=3),
          dict(n_nodes=12, topology="regional", regions=3, link_profile="wan",
               net_perturb=("regional-partition:1", "churn-storm:30")),
          dict(n_nodes=9, topology="organic", net_perturb=("minority-partition:2",)),
          dict(n_nodes=6, topology="full", vote_summaries=False, height_slow_ms=250.0)]


@pytest.mark.parametrize("kw", FLEETS, ids=[str(i) for i in range(len(FLEETS))])
def test_fleet_manifests_are_the_reference_s(kw):
    assert tgen.generate_fleet_manifest(**kw).to_toml() == \
        jgen.generate_fleet_manifest(**kw).to_toml()


def test_cli_generate_writes_the_reference_s_files(tmp_path, capsys):
    out = {}
    for side, mod in (("j", jmain), ("t", tmain)):
        d = tmp_path / side
        assert mod.main(["generate", "--seed", "5", "--count", "6", "--dir", str(d)]) == 0
        capsys.readouterr()
        out[side] = {f: (d / f).read_text() for f in sorted(os.listdir(d))}
    assert out["t"] == out["j"] and len(out["t"]) == 6


def _outcome(mod, manifest_kw: dict, node_kw: dict):
    m = mod.Manifest(**manifest_kw)
    m.nodes = {"node0": mod.NodeManifest(**node_kw), "node1": mod.NodeManifest(),
               "node2": mod.NodeManifest(), "node3": mod.NodeManifest()}
    try:
        m.validate()
        return "ok"
    except ValueError as e:
        return str(e)


def _validate_cases():
    cases = [({}, {"perturb": [p]}) for p in tman.NodeManifest.PERTURBATIONS]
    cases += [({"key_type": "bls12381"}, {"perturb": ["cert-backfill"]}),
              ({}, {"perturb": ["chip-kill:7"]}), ({}, {"perturb": ["chip-flap:8"]}),
              ({}, {"perturb": ["chip-kill:x"]}), ({}, {"perturb": ["kill:1"]}),
              ({}, {"perturb": ["crash-storm:abci.apply"]}),
              ({}, {"perturb": ["crash-storm:no.such.site"]}),
              ({}, {"perturb": ["disk-fault:eio"]}), ({}, {"perturb": ["disk-fault:torn"]}),
              ({}, {"perturb": ["melt"]}), ({}, {"fuzz": "delay"}), ({}, {"fuzz": "loud"}),
              ({}, {"database": "rocks"}), ({}, {"abci_protocol": "quic"}),
              ({"topology": "ring"}, {}), ({"link_profile": "wan"}, {}),
              ({"net_perturb": ["churn-storm:0"]}, {}),
              ({"net_perturb": ["minority-partition:2"]}, {}),
              ({"net_perturb": ["minority-partition:1"]}, {}),
              ({"initial_height": 0}, {}), ({"key_type": "secp256k1"}, {})]
    return cases


@pytest.mark.parametrize("manifest_kw,node_kw", _validate_cases(),
                         ids=[str(i) for i in range(len(_validate_cases()))])
def test_manifest_validation_is_the_reference_s(manifest_kw, node_kw):
    got = _outcome(tman, manifest_kw, node_kw)
    assert got == _outcome(jman, manifest_kw, node_kw)
    if node_kw.get("perturb", [""])[0] in tman.NodeManifest.PERTURBATIONS[:-3]:
        assert got == "ok"


def test_every_e2e4_perturbation_is_accepted():
    """The manifest of chip_smoke's e2e4 phase."""
    m = tman.Manifest(name="e2e4", nodes={
        "node0": tman.NodeManifest(perturb=["device-flap"]),
        "node1": tman.NodeManifest(fuzz="delay", perturb=["kill"]),
        "node2": tman.NodeManifest(perturb=["byzantine"]),
        "node3": tman.NodeManifest(perturb=["flood"])})
    m.validate()
    assert tman.Manifest.from_toml(m.to_toml()).to_toml() == m.to_toml()


def _files(root: str) -> dict[str, bytes]:
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def test_setup_writes_the_reference_s_homes_but_the_backend(tmp_path, monkeypatch):
    """The same keys (the reference's, copied in before the port's setup
    runs) and the same clock give the same files, but for config.toml's
    crypto.backend line: "gpu" (the default) or what the caller asks; a
    "gpu" home also batches peer votes for the card."""
    m = jgen.generate_manifests(11, 4)[1]
    assert len(m.nodes) == 4
    t0 = jtime.Timestamp(1_700_000_000, 123_000_000)
    monkeypatch.setattr(jtime, "canonical_now_ms", lambda: t0)
    monkeypatch.setattr(ttime, "canonical_now_ms",
                        lambda: ttime.Timestamp(t0.seconds, t0.nanos))
    jrun.setup(m, str(tmp_path / "j"), 32000)
    want = _files(str(tmp_path / "j"))
    for backend in ("gpu", "cpu"):
        root = tmp_path / f"t-{backend}"
        for name in m.nodes:  # the reference's keys
            shutil.copytree(tmp_path / "j" / name / "config", root / name / "config")
            for f in os.listdir(root / name / "config"):
                if f not in ("node_key.json", "priv_validator_key.json"):
                    os.remove(root / name / "config" / f)
            os.makedirs(root / name / "data")
            for f in os.listdir(tmp_path / "j" / name / "data"):
                shutil.copy(tmp_path / "j" / name / "data" / f, root / name / "data")
        net = trun.setup(tman.Manifest.from_toml(m.to_toml()), str(root), 32000,
                         **({} if backend == "gpu" else {"backend": "cpu"}))
        assert net.homes == [str(root / n) for n in sorted(m.nodes)]
        got = _files(str(root))
        assert sorted(got) == sorted(want)
        for rel, data in want.items():
            if not rel.endswith("config.toml"):
                assert got[rel] == data, rel
                continue
            # a unix-socket app's path names each home's own root
            mine = data.decode().replace(str(tmp_path / "j"), "<root>").splitlines()
            port = got[rel].decode().replace(str(root), "<root>").splitlines()
            assert len(mine) == len(port), rel
            diff = [(a, b) for a, b in zip(mine, port) if a != b]
            assert sorted(diff) == (sorted([('backend = "cpu"', 'backend = "gpu"'),
                                            ("batch_vote_verification = false",
                                             "batch_vote_verification = true")])
                                    if backend == "gpu" else []), rel


def test_run_manifest_kills_and_respawns_a_one_node_net_on_the_cpu(tmp_path, monkeypatch):
    # the node process verifies with the plain versions on one core (torch's
    # default takes every core, which starves the suite's other workers)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    m = tman.Manifest(name="one-kill", target_height_delta=3,
                      nodes={"node0": tman.NodeManifest(perturb=["kill"])})
    logs = []
    seen = []

    def before_stop(net):
        # the net report is written from the live net, before the hook
        with open(tmp_path / "net_report.json") as f:
            seen.append(("stop", sorted(json.load(f)["nodes"]["node0"])))

    out = trun.run_manifest(m, str(tmp_path), base_port=32100, backend="cpu",
                            log=logs.append,
                            after_perturb=lambda net, rec: seen.append(("perturb", dict(rec))),
                            before_stop=before_stop)
    assert out["kernel_build_s"] == {} and out["height"] >= 3
    (rec,) = out["perturbations"]
    assert rec["node"] == "node0" and rec["perturb"] == "kill"
    assert rec["recovered_height"] >= rec["start_height"] and rec["recovered_s"] > rec["start_s"]
    assert any("kill node0" in line for line in logs) and "OK" in logs[-2]
    assert "(1/1 nodes reporting)" in logs[-1]
    assert seen[0] == ("perturb", rec) and seen[1][0] == "stop" and "error" not in seen[1][1]
    home = tmp_path / "node0"
    assert os.path.getsize(home / "node.log") > 0
    assert (tmp_path / "net_report.json").exists()
