"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``paddle_tpu_torch/csrc/<name>.cu`` compiles, at first use, into
``paddle_tpu_torch/_build/<name>-<hash>.so`` (the directory is listed in
``.gitignore``).  The hash covers the source, the shared headers
(``csrc/*.cuh``) and the compiler flags, so an edited source or header
rebuilds and an unchanged one loads the library already there.  The sources have a plain C interface: no PyTorch headers, so a
build takes seconds.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["build", "library", "ptxas_report", "kernel_label", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# sm_90a keeps Hopper-only instructions (wgmma, setmaxnreg) available
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each build this process ran
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from source at first use")


def _target(name: str) -> Path:
    digest = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile every named source whose library is missing, one ``nvcc``
    per source, all started together.  Returns the wall seconds each
    build took (0.0 for a library already built).  Raises
    ``RuntimeError`` with the compiler's output when a build fails."""
    names = list(dict.fromkeys(names))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, secs = {}, {}
    t0 = time.perf_counter()
    for name in names:
        out = _target(name)
        if out.exists():
            secs[name] = 0.0
            continue
        tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return secs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = ctypes.CDLL(str(_target(name)))
        return lib


# one-letter builtin types of the Itanium mangling, as template arguments
_BUILTIN = {"a": "int8_t", "b": "bool", "c": "char", "d": "double",
            "f": "float", "h": "uint8_t", "i": "int", "j": "unsigned",
            "l": "long", "m": "unsigned long", "s": "short",
            "t": "unsigned short"}


def _ident(s: str, i: int):
    """The length-prefixed identifier at ``s[i:]`` -> (name, end) or None."""
    m = re.match(r"\d+", s[i:])
    if not m:
        return None
    n = int(m.group())
    start = i + len(m.group())
    return s[start:start + n], start + n


def kernel_label(mangled: str) -> str:
    """A kernel's mangled name shortened to ``name<args>``: namespaces
    dropped, template arguments that are integer or bool literals, builtin
    types, plain class names or back-references to them (``S_``,
    ``S0_``, ...) spelled out (anything else as ``?``); a name that is not
    mangled comes back as it is."""
    if not mangled.startswith("_Z"):
        return mangled
    nested = mangled.startswith("_ZN")
    i = 3 if nested else 2
    name, subs = None, []      # subs: the substitutable names so far
    while i < len(mangled):
        got = _ident(mangled, i)
        if got is None:
            break
        name, i = got
        subs.append(name)
        if not nested:
            break
    if name is None:
        return mangled
    if i >= len(mangled) or mangled[i] != "I":
        return name
    i += 1
    args = []
    while i < len(mangled) and mangled[i] != "E":
        c = mangled[i]
        if c == "L":                        # literal: L <type> <value> E
            end = mangled.index("E", i)
            lit = mangled[i + 2:end]
            args.append(lit.replace("n", "-", 1) if lit.startswith("n")
                        else lit)
            i = end + 1
        elif c in _BUILTIN:
            args.append(_BUILTIN[c])
            i += 1
        elif c.isdigit():
            cls, i = _ident(mangled, i)
            subs.append(cls)
            args.append(cls)
        elif c == "S" and re.match(r"S[0-9A-Z]*_", mangled[i:]):
            ref = re.match(r"S([0-9A-Z]*)_", mangled[i:])
            k = int(ref.group(1), 36) + 1 if ref.group(1) else 0
            args.append(subs[k] if k < len(subs) else "?")
            i += len(ref.group())
        else:
            args.append("?")
            break
    return f"{name}<{', '.join(args)}>"


def ptxas_report(log: str) -> Dict[str, dict]:
    """The ``-Xptxas=-v`` lines of one build, by kernel: ``{label:
    {"registers", "spill_stores", "spill_loads", "stack", "smem"}}`` (bytes;
    ``smem`` is the static shared memory ptxas reports, dynamic shared
    memory comes at launch).  Each line belongs to the function named by
    the "Compiling entry function" / "Function properties for" line before
    it."""
    out: Dict[str, dict] = {}
    cur = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?([\w$]+)'?", line)
        if m:
            cur = out.setdefault(kernel_label(m.group(1)), {
                "registers": 0, "spill_stores": 0, "spill_loads": 0,
                "stack": 0, "smem": 0})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur["stack"], cur["spill_stores"], cur["spill_loads"] = (
                int(v) for v in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(sm.group(1)) if sm else 0
    return out
