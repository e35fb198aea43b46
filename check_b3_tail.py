"""B3's tail taken to affine from a local copy of the sum, against the tail
as csrc/bls12381.cu has it (reading the sum in place in shared memory).

Builds two libraries into build/b3tail/: csrc/bls12381.cu as it is
("inplace") and a copy whose bls_point_sum_kernel tail first copies part[0]
into a local proj<T> and hands that to sum_affine ("local"). Then, for each:

1. B3 (bls_launch.point_sum) on G1 and G2 groups of 1,000, 19 and 3 points
   and on one group of 10,240 (phase 1 split over blocks), each held
   against point_sum_plain: the groups whose sum, identity flag or subgroup
   bit differ, and whether any sum's x came back as 1;
2. the small groups again under compute-sanitizer --tool racecheck and
   --tool initcheck, where the tool runs (its exit code and error lines are
   kept, its whole output beside --out);
3. cuobjdump -sass of bls_point_sum_kernel<1> and <2>: the instructions by
   opcode and the number of lines in which the two builds differ.

Run on the card from the repository root (PYTHONPATH=.):

    python3 check_b3_tail.py --out build/b3_tail.json
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import ctypes
import difflib
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
CSRC = ROOT / "cometbft_tpu_torch" / "csrc"
OUT_DIR = ROOT / "build" / "b3tail"
IN_PLACE = "    sum_affine(part[0], n_groups, g, out, is_id);\n"
LOCAL = "    proj<T> s = part[0];\n    sum_affine(s, n_groups, g, out, is_id);\n"
SMALL = (1000, 19, 3)


def build(variant: str) -> tuple[pathlib.Path, float]:
    """csrc/ copied to build/b3tail/<variant>/, the tail patched for
    "local", built with the port's nvcc flags."""
    from cometbft_tpu_torch.ops import _build

    src_dir = OUT_DIR / variant / "csrc"
    if src_dir.exists():
        shutil.rmtree(src_dir)
    shutil.copytree(CSRC, src_dir)
    src = src_dir / "bls12381.cu"
    text = src.read_text()
    if text.count(IN_PLACE) != 1:
        raise RuntimeError("bls12381.cu: B3's tail is not where this script expects it")
    if variant == "local":
        src.write_text(text.replace(IN_PLACE, LOCAL))
    lib = OUT_DIR / variant / "bls12381.so"
    t0 = time.perf_counter()
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc ({variant}): {proc.stdout}")
    return lib, time.perf_counter() - t0


def run_sums(lib: str, big: bool) -> dict:
    """B3 of library `lib` on the groups, each held against its plain
    version on the same card tensors."""
    import numpy as np
    import torch

    import chip_smoke as C
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import bls_launch as BL

    orig = _build.library
    _build.library = lambda stem: ctypes.CDLL(lib) if stem == "bls12381" else orig(stem)
    BL._lib_cache.clear()
    BL._ready.clear()
    dev = torch.device("cuda")
    out = {}
    for g in (1, 2):
        affs = C._bls_points(g, sum(SMALL), 7 + g)
        planes = BL.planes_of_ints(C._bls_coords(g, affs), dev)
        cases = {"small": (np.random.default_rng(g).permutation(sum(SMALL)),
                           np.cumsum([0, *SMALL]))}
        if big:
            cases["10240"] = (np.arange(10_240) % sum(SMALL), np.array([0, 10_240]))
        for name, (order, starts) in cases.items():
            order_t = torch.from_numpy(order.astype(np.int32)).to(dev)
            starts_t = torch.from_numpy(starts.astype(np.int32)).to(dev)
            got = BL.point_sum(g, planes, order_t, starts_t, True)
            torch.cuda.synchronize()
            want = BL.point_sum_plain(g, planes, order_t, starts_t, True)
            gv, wv = BL.values(got[0]), BL.values(want[0])
            out[f"g{g}_{name}"] = {
                # groups whose affine sum, identity flag or subgroup bit differ
                "groups_differing": sum(
                    1 for j in range(len(gv[0]))
                    if [c[j] for c in gv] != [c[j] for c in wv]
                    or int(got[1][j]) != int(want[1][j]) or int(got[2][j]) != int(want[2][j])),
                "x_is_one": [x == 1 for x in gv[0]],  # x (its c0 for G2) of each sum
            }
    return out


def sanitize(tool: str, lib: pathlib.Path, log: pathlib.Path | None) -> dict:
    """The small groups under compute-sanitizer's `tool`; its whole output
    goes to `log`."""
    exe = shutil.which("compute-sanitizer") or "/usr/local/cuda/bin/compute-sanitizer"
    if not os.path.exists(exe):
        return {"ran": False, "why": "compute-sanitizer not found"}
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([exe, "--tool", tool, sys.executable, __file__, "--run",
                               str(lib)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, timeout=900, env={**os.environ,
                                                           "PYTHONPATH": str(ROOT)})
    except subprocess.TimeoutExpired:
        return {"ran": False, "why": "timed out after 900 s"}
    if log is not None:
        log.write_text(proc.stdout)
    lines = proc.stdout.strip().splitlines()
    return {"ran": True, "exit": proc.returncode, "seconds": time.perf_counter() - t0,
            "errors": [ln for ln in lines if ln.startswith("=========") and (
                "Error" in ln or "ERROR" in ln or "hazard" in ln or "Race" in ln
                or "Uninitialized" in ln or "at " in ln)][:30],
            "tail": lines[-12:]}


def sass(lib: pathlib.Path) -> dict[str, list[str]]:
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([exe, "-sass", str(lib)], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1) if "bls_point_sum_kernel" in m.group(1) else None
            if name:
                funcs[name] = []
        elif name and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            # the instruction without its address and encoding
            funcs[name].append(re.sub(r"/\*[0-9a-f]+\*/", "", line).split(";")[0].strip())
    return funcs


def opcodes(lines: list[str]) -> dict[str, int]:
    c = collections.Counter(ln.split()[0] if not ln.startswith("@") else ln.split()[1]
                            for ln in lines if ln)
    return dict(c.most_common(12))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="")
    ap.add_argument("--run", default="", help="(internal) run the sums with this library")
    args = ap.parse_args()
    if args.run:
        print(json.dumps(run_sums(args.run, big=False)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("check_b3_tail: no CUDA device", file=sys.stderr)
        return 1
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        libs = dict(zip(("inplace", "local"), pool.map(build, ("inplace", "local"))))
    report = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, text=True).stdout.strip(),
        "nvcc_s": {v: s for v, (_, s) in libs.items()}}
    logs = pathlib.Path(args.out).parent if args.out else None
    for variant, (lib, _) in libs.items():
        report[variant] = {"sums": run_sums(str(lib), big=True)}
        for tool in ("racecheck", "initcheck"):
            report[variant][tool] = sanitize(
                tool, lib, logs / f"b3_tail_{variant}_{tool}.log" if logs else None)
    a, b = sass(libs["inplace"][0]), sass(libs["local"][0])
    report["sass"] = {name: {"inplace_lines": len(a[name]), "local_lines": len(b.get(name, [])),
                             "differing_lines": sum(1 for d in difflib.unified_diff(
                                 a[name], b.get(name, []), lineterm="", n=0)
                                 if d[:1] in "+-" and d[:3] not in ("+++", "---")),
                             "inplace_ops": opcodes(a[name]),
                             "local_ops": opcodes(b.get(name, []))}
                      for name in sorted(a)}
    text = json.dumps(report, indent=1)
    print(text)
    if args.out:
        pathlib.Path(args.out).write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
