"""Build the port's CUDA kernels on first use and load them with ctypes.

Each ``src/repro_torch/csrc/<name>.cu`` is one self-contained source with a
plain C interface (no PyTorch headers), compiled by ``nvcc`` for Hopper
(``sm_90a``) into ``build/kernels/<name>-<hash>.so`` at the repository
root.  The hash covers the source text and the compiler flags, so an
edited source rebuilds and an unchanged one is loaded as it is.
The two attention sources, which hold most of the kernels, build with
``--split-compile=0``, which spreads a source's kernels over the host's
cores: 48 decode kernels built in 24.1 s instead of 49.3, with the same
registers and kernel times (CUDA 12.9, on the 8 cores of an H100 80GB
HBM3 host).  The scans build without it: it changed the registers of two
rwkv6_scan kernels.
Importing this module compiles nothing and needs no ``nvcc``: the build
runs inside ``load`` / ``build``, which only a CUDA launch reaches.
``ptxas``'s report of each kernel's registers, spills and static shared
memory is kept beside the library (``<name>-<hash>.log``) and read back
by ``resources``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("flash_attention", "decode_attention", "rwkv6_scan", "mamba_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas=-v")
SPLIT_COMPILE = ("flash_attention", "decode_attention")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                           "kernels are built on first use")
    return found


def flags(name: str) -> Tuple[str, ...]:
    """``nvcc``'s flags for ``csrc/<name>.cu``."""
    return NVCC_FLAGS + (("--split-compile=0",) if name in SPLIT_COMPILE
                         else ())


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(flags(name)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{h}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every named source that is not built yet, one ``nvcc`` per
    source, all started together.  Returns seconds per source built
    (empty when everything was already built); raises with the
    compiler's output on failure."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    t0 = time.monotonic()
    procs = {}
    for n in todo:
        out = library_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *flags(n), "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    secs, errors = {}, []
    for n, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        secs[n] = time.monotonic() - t0
        if p.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu (exit {p.returncode}):\n"
                          f"{log}")
            tmp.unlink(missing_ok=True)
        else:
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)       # atomic: a reader sees all or none
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib


def resources(name: str) -> List[str]:
    """One line per kernel of the built ``csrc/<name>.cu``: its
    (demangled, where ``c++filt`` exists) name, registers, spill bytes and
    static shared memory, from ``ptxas -v``, and whether ptxas serialized
    its ``wgmma`` pipeline (warning C7514); empty if not built here."""
    log = library_path(name).with_suffix(".log")
    if not log.exists():
        return []
    text = log.read_text()
    serialized = set(re.findall(r"wgmma\.mma_async instructions are "
                                r"serialized.*?in the function '(\S+)'", text))
    rows, fn, spill = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = f"spill {m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            smem = re.search(r"(\d+) bytes smem", line)
            rows.append([fn, f"{m.group(1)} registers", spill,
                         f"{smem.group(1) if smem else 0} B static smem",
                         "wgmma serialized" if fn in serialized else ""])
            fn, spill = None, ""
    filt = shutil.which("c++filt")
    if filt and rows:
        names = subprocess.run([filt], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True).stdout
        for r, n in zip(rows, names.splitlines()):
            r[0] = n.replace("(anonymous namespace)::", "").split("(")[0]
    return [", ".join(x for x in r if x) for r in rows]
