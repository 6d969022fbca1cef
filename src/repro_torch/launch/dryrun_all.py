"""Driver: run the dry-run for every (arch x shape x mesh) combination in
separate subprocesses (a fresh interpreter and fake world per count,
resumable via the per-combination JSON files).

Port of ``repro.launch.dryrun_all``, with the reference's flags:

    PYTHONPATH=src python -m repro_torch.launch.dryrun_all [--jobs 2] \\
        [--out results/dryrun_torch] [--single-only] [--arch ARCH]
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

from repro_torch.configs import archs
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch.dryrun import FAILED


def combos(single_only: bool = False):
    meshes = [False] if single_only else [False, True]
    for arch in archs.ARCHS:
        for shape in SHAPES:
            for multi in meshes:
                yield arch, shape, multi


def run_one(arch: str, shape: str, multi: bool, out: str) -> str:
    tag = f"{arch}__{shape}__{'multi' if multi else 'single'}"
    path = os.path.join(out, tag + ".json")
    if os.path.exists(path):
        return f"SKIP(exists) {tag}"
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", arch, "--shape", shape, "--out", out]
    if multi:
        cmd.append("--multi-pod")
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = src
    t0 = time.time()
    r = subprocess.run(cmd, env=env, capture_output=True, text=True,
                       timeout=3600)
    dt = time.time() - t0
    if r.returncode != 0:
        with open(os.path.join(out, tag + ".err"), "w") as f:
            f.write(r.stdout + "\n==== STDERR ====\n" + r.stderr)
        return f"FAIL {tag} ({dt:.0f}s): {failure(r.stderr)}"
    return f"OK   {tag} ({dt:.0f}s)"


def failure(stderr: str) -> str:
    """The exception a failed count raised, as ``dryrun.main`` reports
    it (its type and its message's first line, so that an exception
    with no message still names itself), else stderr's last line."""
    lines = [ln for ln in stderr.splitlines() if ln.strip()]
    for ln in reversed(lines):
        if ln.startswith(FAILED):
            return ln[len(FAILED):]
    return lines[-1] if lines else "no output"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--single-only", action="store_true")
    ap.add_argument("--arch", default=None)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    todo = [c for c in combos(args.single_only)
            if args.arch is None or c[0] == args.arch]
    print(f"{len(todo)} combinations")
    with ThreadPoolExecutor(max_workers=args.jobs) as ex:
        for msg in ex.map(lambda c: run_one(*c, args.out), todo):
            print(msg, flush=True)


if __name__ == "__main__":
    main()
