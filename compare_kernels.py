"""Time the pubkey decoders, the microbench's loop kernel (K3), the
challenge kernel (K5) and the integrity kernel (K6) of this checkout and of
another one on the same CUDA card, in turns.

    python3 compare_kernels.py OTHER_DIR [--out FILE]

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
chip_smoke.k5_inputs) and K6 (header and payload over that block), each
held bit for bit against its tree's plain version first, per launch on the
card alone (chip_smoke.time_launch: the wrapper's host work hidden behind
a sleep on the card) and back to back; a tree that predates them reports
none. It prints one line per reading and, last, one JSON object with all of them;
--out writes that object to FILE as well. Needs one card; exits non-zero
without one.
"""

from __future__ import annotations

import argparse
import json
import pathlib
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


def _child(tree: pathlib.Path, words_file: pathlib.Path) -> dict:
    """This process times `tree`'s decoders: its package first on sys.path
    (chip_smoke, already imported from this tree, loads the port lazily)."""
    sys.path.insert(0, str(tree))
    from cometbft_tpu_torch.ops import field as F
    from cometbft_tpu_torch.ops import verify_kernel as VK

    if not pathlib.Path(VK.__file__).resolve().is_relative_to(tree.resolve()):
        raise RuntimeError(f"{VK.__file__} is not in {tree}")
    device = torch.device("cuda")
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


def _time_k5_k6(device) -> dict:
    """K5 and K6 of the imported tree, held and timed; none before the
    tree had them."""
    try:
        from cometbft_tpu_torch.ops import challenge as CH
        from cometbft_tpu_torch.ops import integrity as IN
    except ImportError:
        return {}
    plen, var, tlen = CS.VOTE_GEOMETRY
    flat, aw, ptab = CS.k5_inputs(CS.N_BIG, CS.VOTE_GEOMETRY, device)
    k5 = lambda: CH.derive(flat, aw, ptab, CS.N_BIG, var, plen, tlen)  # noqa: E731
    if not torch.equal(k5(), CH.derive_plain(flat, aw, ptab, CS.N_BIG, var, plen, tlen)):
        raise AssertionError("K5 differs from plain")
    mask = torch.ones(CS.N_BIG, dtype=torch.bool, device=device)
    expected = int(IN.checksum_plain(flat))
    k6 = lambda: IN.integrity_parts(mask, mask.all(), expected, flat)  # noqa: E731
    if CS._max_err(k6(), IN.parts_plain(mask, mask.all(), expected, flat)):
        raise AssertionError("K6 differs from plain")
    return {f"{name} {CS.N_BIG}": {"ms": CS.time_launch(fn),
                                   "ms_back_to_back": CS.time_back_to_back(fn)}
            for name, fn in (("k5 derive", k5), ("k6 integrity", k6))}


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
    # one tree's timing process: the tree and the encodings' file
    ap.add_argument("--child", type=pathlib.Path, help=argparse.SUPPRESS)
    ap.add_argument("--words", type=pathlib.Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device", file=sys.stderr)
        return 1
    if args.child:
        print(json.dumps(_child(args.child, args.words)), flush=True)
        return 0
    if args.other is None:
        ap.error("the other checkout is required")
    card = CS._smi()
    print(card, flush=True)
    words_file = _words_file()
    trees = {"other": args.other.resolve(), "this": HERE}
    runs = []
    for label in ("other", "this", "this", "other"):
        done = subprocess.run([sys.executable, str(HERE / "compare_kernels.py"),
                               "--child", str(trees[label]), "--words", str(words_file)],
                              capture_output=True, text=True, check=False)
        if done.returncode:
            sys.stderr.write(done.stdout + done.stderr)
            raise RuntimeError(f"{label} tree ({trees[label]}): exit {done.returncode}")
        times = json.loads(done.stdout.strip().splitlines()[-1])
        runs.append({"tree": label, "times": times})
        for key, t in times.items():
            unit = ("lanes and iterations" if key.startswith("k3 ") else
                    "lanes" if key.startswith(("k5 ", "k6 ")) else "keys")
            print(f"[{card}] {label} tree, {key} {unit}: {t['ms']:.4f} ms per launch (median "
                  f"of 20), {t['ms_back_to_back']:.4f} ms back to back (mean of 50)", flush=True)
    result = {"card": card, "other": str(trees["other"]), "runs": runs}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
