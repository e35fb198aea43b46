"""Time the pubkey decoders, the microbench's loop kernel (K3), the
challenge kernel (K5) and the integrity kernel (K6) of this checkout and of
another one on the same CUDA card, in turns.

    python3 compare_kernels.py OTHER_DIR [--out FILE] [--probes | --e2e]
    python3 compare_kernels.py --staging [--out FILE]

OTHER_DIR is another checkout of the repository, for example an earlier
commit unpacked with ``git archive`` into a directory that .gitignore
lists. Both trees decode the same encodings: the pubkeys of chip_smoke.py's
commits (seed SEED_CHECK) at 10,240, 6,144 and 256 keys, the decoders'
launches on the main paths. Each tree runs in a process of its own, with
its own package and its own build/, in the order other, this, this, other.
Each process first holds each decoder's output against its tree's plain
version (ok bit for bit, X, Y, Z, T by canonical value), then times each
decoder per launch (chip_smoke.time_kernel: the median of 20 launches, each
between two CUDA events) and back to back (chip_smoke.time_back_to_back:
the mean of 50 launches between two events). Then the same for K3's bodies
of chip_smoke.K3_RECORDS at 128 and 10,240 lanes, each at its record's
iterations per launch, on the probes' seeded state, after holding each
against its tree's plain version at 7 iterations (the value bodies by
canonical value, whichever limbs a tree's kernel writes, and every body so
on a tree that predates the value bodies; the limb bodies bit for bit).
Then K5 (derive over chip_smoke.VOTE_GEOMETRY at 10,240 lanes, on
chip_smoke.k5_inputs, lanes over 16 table rows, and over one row as a
commit's lanes are), K5's hashing
alone (its standalone SHA-512 and reduction entries on pre-padded rows of
the same 186 bytes) and K6 (header and payload over that block), each held
bit for bit against its tree's plain version first, per launch on the card
alone (chip_smoke.time_launch: the wrapper's host work hidden behind a
sleep on the card), back to back, and the wrapper's host time a call
(chip_smoke.time_host); a tree that predates them reports none.
--probes then reads this tree's K5 further, in this process: back to back
by lanes (PROBE_LANES), the SM clock and power while K5 runs back to back,
the launch floor (a one-word torch fill timed as the kernels), and the
static SASS of K5's kernels by opcode (cuobjdump, where the toolkit has
it). It prints one line per reading and, last, one JSON object with all
of them; --out writes that object to FILE as well. Needs one card; exits
non-zero without one.

--e2e times, instead of the kernels, each tree's warm verify() of
chip_smoke.py's ed25519 10k, sr25519 10k and mixed 10k commits (the same
seeds and tampered lanes, make_verifier -> add -> verify as chip_smoke's
drive runs it): one cold run, then E2E_REPS warm runs, each on the host
clock between two synchronisations, their median and spread. The trees
run the same harness in fresh processes, so a gap between them is the
trees' code, not what ran before in the process.

--staging times, in this tree and this process only, the warm verify() of
the ed25519 10k commit with a batch's staged arrays (the packed block and
the fallback challenges, ed25519_kernel._to_device) sent two ways, in
turns: by the tree's plain copies from pageable memory, and from
page-locked blocks (PinnedStaging: a ring of blocks, each reused once the
event recorded after its non_blocking copy has passed, as the reference's
DoubleBuffer does). For each way, STAGING_REPS runs by part
(ed25519_kernel.timed_parts, synchronised around each part) and as many
on the host clock alone, their medians and spreads.
"""

from __future__ import annotations

import argparse
import functools
import json
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as CS

HERE = pathlib.Path(__file__).resolve().parent
SCHEMES = ("ed25519", "sr25519")


def _words_file() -> pathlib.Path:
    """The encodings both trees decode, made once in this tree's build/."""
    out = HERE / "build" / "decoder_words.npz"
    out.parent.mkdir(exist_ok=True)
    paths = CS._paths()
    arrays = {}
    for name in SCHEMES:
        path = paths[name]
        for n in CS.DECODE_LANES:
            pubs = path.make_commit(n, CS.SEED_CHECK)[0]
            arrays[f"{name}_{n}"] = CS.encoding_words(pubs, n, path.scheme.id_enc).T
    np.savez(out, **arrays)
    return out


def _child(tree: pathlib.Path, words_file: pathlib.Path, e2e: bool) -> dict:
    """This process times `tree`'s kernels, or with `e2e` its verify():
    its package first on sys.path (chip_smoke, already imported from this
    tree, loads the port lazily)."""
    sys.path.insert(0, str(tree))
    from cometbft_tpu_torch.ops import field as F
    from cometbft_tpu_torch.ops import verify_kernel as VK

    if not pathlib.Path(VK.__file__).resolve().is_relative_to(tree.resolve()):
        raise RuntimeError(f"{VK.__file__} is not in {tree}")
    device = torch.device("cuda")
    if e2e:
        return _time_e2e(device)
    data = np.load(words_file)
    out = {}
    for name in SCHEMES:
        kernel, plain = ((VK.decompress, VK.decompress_math) if name == "ed25519"
                         else (VK.decompress_sr, VK.decompress_sr_math))
        for n in CS.DECODE_LANES:
            host = np.ascontiguousarray(data[f"{name}_{n}"]).view(np.int32)
            words = torch.from_numpy(host).to(device)
            got, want = kernel(words), plain(torch.from_numpy(host))
            if not torch.equal(got[0].cpu(), want[0]) or any(
                    not torch.equal(F.canonicalize(a.cpu()), F.canonicalize(b))
                    for a, b in zip(got[1:], want[1:])):
                raise AssertionError(f"{tree}: {name} decoder at {n} keys differs from plain")
            out[f"{name}_{n}"] = {"ms": CS.time_kernel(lambda: kernel(words)),
                                  "ms_back_to_back": CS.time_back_to_back(
                                      lambda: kernel(words))}
    out.update(_time_k3(F, device))
    out.update(_time_k5_k6(device))
    return out


E2E_REPS = 15


def _time_e2e(device) -> dict:
    """The imported tree's warm verify() of the three 10k cells (see the
    module's docstring): {cell: {"cold_ms", "warm_ms" (median), "warm_min_ms",
    "warm_max_ms"}}. Each run's mask must be the expected one."""
    from cometbft_tpu_torch.crypto import batch as crypto_batch

    paths = CS._paths()
    cells = {"ed25519 10k": (crypto_batch.create_batch_verifier,
                             CS.commit_cell(paths["ed25519"], CS.N_BIG, CS.SEED_BIG)),
             "sr25519 10k": (crypto_batch.create_batch_verifier,
                             CS.commit_cell(paths["sr25519"], CS.N_BIG, CS.SEED_SR)),
             "mixed 10k": (lambda _key: crypto_batch.create_mixed_batch_verifier(),
                           CS.mixed_commit(paths, CS.N_BIG, CS.SEED_MIXED))}
    out = {}
    for cell, (make, (keys, msgs, sigs, bad)) in cells.items():
        expected = [i not in bad for i in range(len(sigs))]

        def run():
            v = make(keys[0])
            for key, m, s in zip(keys, msgs, sigs):
                v.add(key, m, s)
            if v.verify()[1] != expected:
                raise AssertionError(f"{cell}: wrong mask")

        cold = CS.time_wall(run, 1, device)
        warm = [CS.time_wall(run, 1, device) for _ in range(E2E_REPS)]
        out[cell] = {"cold_ms": cold, "warm_ms": float(np.median(warm)),
                     "warm_min_ms": min(warm), "warm_max_ms": max(warm)}
    return out


STAGING_REPS = 15


class PinnedStaging:
    """ed25519_kernel._to_device from page-locked host blocks: a ring of
    blocks used in turn, each copy non_blocking, a block written again only
    after the event recorded behind its last copy."""

    def __init__(self, ring: int = 8):
        self.blocks: list = [None] * ring
        self.events: list = [None] * ring
        self.turn = 0

    def __call__(self, a: np.ndarray, device) -> torch.Tensor:
        a = np.ascontiguousarray(a).view(np.int32)
        k, self.turn = self.turn, (self.turn + 1) % len(self.blocks)
        if self.events[k] is not None:
            self.events[k].synchronize()
        if self.blocks[k] is None or self.blocks[k].numel() < a.nbytes:
            self.blocks[k] = torch.empty(max(a.nbytes, 1 << 20), dtype=torch.uint8,
                                         pin_memory=True)
        host = self.blocks[k][:a.nbytes]
        host.numpy()[:] = a.reshape(-1).view(np.uint8)
        out = torch.empty(a.shape, dtype=torch.int32, device=device)
        out.view(-1).view(torch.uint8).copy_(host, non_blocking=True)
        self.events[k] = torch.cuda.Event()
        self.events[k].record()
        return out


def _time_staging(device, card: str) -> dict:
    """This tree's 10k ed25519 verify() with plain and with pinned staging
    copies (see the module's docstring)."""
    import statistics

    from cometbft_tpu_torch.crypto import batch as crypto_batch
    from cometbft_tpu_torch.ops import ed25519_kernel as EK

    keys, msgs, sigs, bad = CS.commit_cell(CS._paths()["ed25519"], CS.N_BIG, CS.SEED_BIG)
    expected = [i not in bad for i in range(len(sigs))]

    def run():
        v = crypto_batch.create_batch_verifier(keys[0])
        for key, m, s in zip(keys, msgs, sigs):
            v.add(key, m, s)
        if v.verify()[1] != expected:
            raise AssertionError("staging: wrong mask")

    ways = {"plain": EK._to_device, "pinned": PinnedStaging()}
    parts = {w: [] for w in ways}
    wall = {w: [] for w in ways}
    for rep in range(STAGING_REPS + 1):  # the first round warms both ways
        for way, fn in ways.items():
            EK._to_device = fn
            try:
                got: dict = {}
                with EK.timed_parts(got):
                    run()
                ms = CS.time_wall(run, 1, device)
            finally:
                EK._to_device = ways["plain"]
            if rep:
                parts[way].append(got)
                wall[way].append(ms)
    out = {}
    for way in ways:
        names = sorted({k for p in parts[way] for k in p})
        by = {k: [p.get(k, 0.0) for p in parts[way]] for k in names}
        out[way] = {"wall_ms": statistics.median(wall[way]), "wall_min_ms": min(wall[way]),
                    "wall_max_ms": max(wall[way]),
                    "parts_ms": {k: statistics.median(v) for k, v in by.items()},
                    "parts_min_ms": {k: min(v) for k, v in by.items()},
                    "parts_max_ms": {k: max(v) for k, v in by.items()}}
        o = out[way]
        print(f"[{card}] staging {way}, ed25519 10k verify(): wall {o['wall_ms']:.3f} ms (median "
              f"of {STAGING_REPS}, {o['wall_min_ms']:.3f}-{o['wall_max_ms']:.3f}); by part "
              + ", ".join(f"{k} {o['parts_ms'][k]:.3f} ({o['parts_min_ms'][k]:.3f}-"
                          f"{o['parts_max_ms'][k]:.3f})" for k in names), flush=True)
    return out


def _time_k5_k6(device) -> dict:
    """K5 and K6 of the imported tree, held and timed, with their wrappers'
    host time, and K5's hashing alone (chip_smoke._k5_hash_only, on the
    tree's standalone entries); none before the tree had them. K6 takes the
    verify kernel's raw int32 verdicts where the tree has them, else
    bools."""
    try:
        from cometbft_tpu_torch.ops import challenge as CH
        from cometbft_tpu_torch.ops import integrity as IN
    except ImportError:
        return {}
    from cometbft_tpu_torch.ops import verify_kernel as VK

    plen, var, tlen = CS.VOTE_GEOMETRY
    flat, aw, ptab = CS.k5_inputs(CS.N_BIG, CS.VOTE_GEOMETRY, device)
    want = CH.derive_plain(flat, aw, ptab, CS.N_BIG, var, plen, tlen)
    fns = {"k5 derive": lambda: CH.derive(flat, aw, ptab, CS.N_BIG, var, plen, tlen)}
    f1, a1, p1 = CS.k5_inputs(CS.N_BIG, CS.VOTE_GEOMETRY, device, seed=9, rows=1)
    fns["k5 derive one row"] = lambda: CH.derive(f1, a1, p1, CS.N_BIG, var, plen, tlen)
    for name, fn in fns.items():
        plain = want if name != "k5 derive one row" else CH.derive_plain(
            f1, a1, p1, CS.N_BIG, var, plen, tlen)
        if not torch.equal(fn(), plain):
            raise AssertionError(f"{name} differs from plain")
    fns["k5 hashing alone"] = CS._k5_hash_only(device)
    raw = hasattr(VK, "verify_ok_raw")
    mask = torch.ones(CS.N_BIG, dtype=torch.int32 if raw else torch.bool, device=device)
    allok = torch.ones(1, dtype=torch.int32, device=device) if raw else mask.all()
    expected = int(IN.checksum_plain(flat))
    k6 = lambda: IN.integrity_parts(mask, allok, expected, flat)  # noqa: E731
    if CS._max_err(k6(), IN.parts_plain(mask, allok, expected, flat)):
        raise AssertionError("K6 differs from plain")
    fns["k6 integrity"] = k6
    return {f"{name} {CS.N_BIG}": {"ms": CS.time_launch(fn),
                                   "ms_back_to_back": CS.time_back_to_back(fn),
                                   "host_ms": CS.time_host(fn)}
            for name, fn in fns.items()}


# K5's lane counts for --probes: a lone warp to two warps a scheduler of
# the 132 SMs (one warp a scheduler at 16,896)
PROBE_LANES = (32, 256, 4_224, CS.N_MIXED_BUCKET, 8_448, CS.N_BIG, 16_896, 33_792)


def _probes(device, card: str) -> dict:
    """This tree's K5 read further (see the module's docstring)."""
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import challenge as CH

    plen, var, tlen = CS.VOTE_GEOMETRY
    sweep = {}
    for lanes in PROBE_LANES:
        flat, aw, ptab = CS.k5_inputs(lanes, CS.VOTE_GEOMETRY, device, seed=lanes)
        sweep[lanes] = CS.time_back_to_back(
            functools.partial(CH.derive, flat, aw, ptab, lanes, var, plen, tlen))
    print(f"[{card}] k5 derive back to back by lanes (ms, mean of 50): "
          + ", ".join(f"{n:,} {t:.4f}" for n, t in sweep.items()), flush=True)
    flat, aw, ptab = CS.k5_inputs(CS.N_BIG, CS.VOTE_GEOMETRY, device)
    for _ in range(20_000):  # ~0.5 s of K5 back to back while the SM clock is read
        CH.derive(flat, aw, ptab, CS.N_BIG, var, plen, tlen)
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
                             "--format=csv,noheader"], capture_output=True, text=True,
                            check=True, timeout=60).stdout.strip()
    torch.cuda.synchronize()
    one = torch.zeros(1, dtype=torch.int32, device=device)
    floor = {"ms": CS.time_launch(one.zero_), "ms_back_to_back": CS.time_back_to_back(one.zero_)}
    print(f"[{card}] SM clock, max SM clock, power during k5 back to back: {clocks}; the launch "
          f"floor (a one-word torch fill, timed as the kernels): {floor['ms']:.4f} ms alone, "
          f"{floor['ms_back_to_back']:.4f} back to back", flush=True)
    sass = {}
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if pathlib.Path(tool).exists():
        lib = _build._target(_build.CSRC_DIR / "challenge25519.cu")
        done = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                              check=True, timeout=120)
        cur = None
        for line in done.stdout.splitlines():
            m = re.search(r"Function : (\w+)", line)
            if m:
                cur = CS._kernel_label(m.group(1)) or m.group(1)
                sass[cur] = {}
                continue
            m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
            if m and cur:
                op = m.group(1).split(".")[0]
                sass[cur][op] = sass[cur].get(op, 0) + 1
        for kernel, ops in sass.items():
            top = sorted(ops.items(), key=lambda kv: -kv[1])[:12]
            print(f"[{card}] SASS {kernel}: {sum(ops.values())} instructions; "
                  + ", ".join(f"{op} {n}" for op, n in top), flush=True)
    else:
        print("compare_kernels: no cuobjdump, no SASS histogram", flush=True)
    return {"k5_back_to_back_by_lanes": sweep, "clocks_under_k5": clocks,
            "launch_floor": floor, "sass": sass}


def _time_k3(F, device) -> dict:
    """K3's record bodies of the imported tree, held and timed."""
    from cometbft_tpu_torch.ops import microbench as MB

    # the bodies compared by canonical value: the tree's value bodies, or
    # every body for a tree that predates them (its kernel writes the plain
    # version's limbs, so canonical values agree wherever limbs do)
    by_value = getattr(MB, "VALUE_BODIES", frozenset(range(MB.N_BODIES)))
    out = {}
    for name, iters, _, _ in CS.K3_RECORDS:
        body = MB.BODIES[name]
        for lanes in CS.MB_LANES:
            state = torch.from_numpy(MB.probe_state(body.n_state, lanes)).to(device)
            got, want = MB.loop(name, state, 7).cpu(), MB.loop_plain(name, state.cpu(), 7)
            if body.body_id in by_value:
                got, want = (torch.stack([F.canonicalize(c) for c in x.unbind(0)])
                             for x in (got, want))
            if not torch.equal(got, want):
                raise AssertionError(f"K3 {name!r} at {lanes} lanes differs from plain")
            out[f"k3 {name}_{lanes}_x{iters}"] = {
                "ms": CS.time_kernel(lambda: MB.loop(name, state, iters)),
                "ms_back_to_back": CS.time_back_to_back(lambda: MB.loop(name, state, iters))}
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=pathlib.Path, nargs="?", help="the other checkout")
    ap.add_argument("--out", type=pathlib.Path, help="also write the JSON object here")
    ap.add_argument("--probes", action="store_true",
                    help="then read this tree's K5 further (see the docstring)")
    ap.add_argument("--e2e", action="store_true",
                    help="time each tree's warm verify() instead of the kernels")
    ap.add_argument("--staging", action="store_true",
                    help="time this tree's 10k verify() with plain and pinned staging copies")
    # one tree's timing process: the tree and the encodings' file
    ap.add_argument("--child", type=pathlib.Path, help=argparse.SUPPRESS)
    ap.add_argument("--words", type=pathlib.Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device", file=sys.stderr)
        return 1
    if args.child:
        print(json.dumps(_child(args.child, args.words, args.e2e)), flush=True)
        return 0
    if args.staging:
        card = CS._smi()
        print(card, flush=True)
        result = {"card": card, "staging": _time_staging(torch.device("cuda"), card)}
        if args.out:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text(json.dumps(result, indent=1))
        print(json.dumps(result))
        return 0
    if args.other is None:
        ap.error("the other checkout is required")
    card = CS._smi()
    print(card, flush=True)
    words_file = None if args.e2e else _words_file()
    trees = {"other": args.other.resolve(), "this": HERE}
    runs = []
    for label in ("other", "this", "this", "other"):
        done = subprocess.run([sys.executable, str(HERE / "compare_kernels.py"),
                               "--child", str(trees[label]), "--words", str(words_file)]
                              + (["--e2e"] if args.e2e else []),
                              capture_output=True, text=True, check=False)
        if done.returncode:
            sys.stderr.write(done.stdout + done.stderr)
            raise RuntimeError(f"{label} tree ({trees[label]}): exit {done.returncode}")
        times = json.loads(done.stdout.strip().splitlines()[-1])
        runs.append({"tree": label, "times": times})
        for key, t in times.items():
            if "warm_ms" in t:
                print(f"[{card}] {label} tree, verify() {key}: cold {t['cold_ms']:.3f} ms, warm "
                      f"{t['warm_ms']:.3f} ms (median of {E2E_REPS}, {t['warm_min_ms']:.3f}-"
                      f"{t['warm_max_ms']:.3f})", flush=True)
                continue
            unit = ("lanes and iterations" if key.startswith("k3 ") else
                    "lanes" if key.startswith(("k5 ", "k6 ")) else "keys")
            print(f"[{card}] {label} tree, {key} {unit}: {t['ms']:.4f} ms per launch (median "
                  f"of 20), {t['ms_back_to_back']:.4f} ms back to back (mean of 50)"
                  + (f", wrapper host time {t['host_ms']:.4f} ms a call (median of 20)"
                     if "host_ms" in t else ""), flush=True)
    result = {"card": card, "other": str(trees["other"]), "runs": runs}
    if args.probes:
        result["probes"] = _probes(torch.device("cuda"), card)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
