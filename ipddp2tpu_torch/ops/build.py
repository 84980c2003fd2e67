"""Building the package's CUDA sources with `nvcc`.

Every kernel of the package is a `.cu` file under `ops/csrc/` with a plain C
interface, compiled for `sm_90a` into a shared library under `ops/_build/`
at first use and bound with `ctypes`. A library's name carries a hash of its
sources, so an edited source builds anew. `start` launches one `nvcc`
process and returns at once; `finish` waits for it. Starting several before
finishing any builds them in parallel.

Nothing here runs at import: a machine without a CUDA toolkit imports every
module of the package and fails only when a kernel is asked for.
"""

from __future__ import annotations

import hashlib
import os
import re
import subprocess
from pathlib import Path
from typing import NamedTuple, Optional

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
# shared memory one block may use on an H100 (227 KB)
SMEM_LIMIT = 232448


class Build(NamedTuple):
    """One started build: the `nvcc` process (None if the library was
    there already), where it writes, and the library's final path."""

    proc: Optional[subprocess.Popen]
    tmp: Optional[Path]
    out: Path


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (nvcc): cannot build "
                           "the package's CUDA kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def source_tag(*sources: Path) -> str:
    """Hash of the sources a library is built from."""
    h = hashlib.sha1()
    for s in sources:
        h.update(s.read_bytes())
    return h.hexdigest()[:12]


def start(stem: str, source: Path, defines=(), depends=(),
          verbose: bool = False) -> Build:
    """Start `nvcc` on `source` with `-D` flags `defines`; `depends` are the
    headers it includes (hashed with it). The library is
    `_build/<stem>_<hash>.so`."""
    out = BUILD_DIR / f"{stem}_{source_tag(source, *depends)}.so"
    if out.exists():
        return Build(None, None, out)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", str(CSRC)]
    cmd += [f"-D{d}" for d in defines]
    if verbose:
        cmd.append("-Xptxas=-v")
    cmd += ["-o", str(tmp), str(source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return Build(proc, tmp, out)


def finish(build: Build, verbose: bool = False, logs=None) -> Path:
    """Wait for a started build; raises with the compiler's output if it
    failed. A dict `logs` receives the compiler's output by library name
    (with `verbose` that is the `-Xptxas -v` report)."""
    if build.proc is None:
        return build.out
    log, _ = build.proc.communicate()
    if build.proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({build.proc.returncode}) building "
                           f"{build.out.name}:\n{log}")
    if logs is not None:
        logs[build.out.name] = log
    elif verbose and log:
        print(log, flush=True)
    os.replace(build.tmp, build.out)
    return build.out


def finish_all(builds, verbose: bool = False, logs=None):
    """Wait for every started build, then raise the first failure: no
    `nvcc` process is left running."""
    paths, first = [], None
    for b in builds:
        try:
            paths.append(finish(b, verbose=verbose, logs=logs))
        except RuntimeError as e:
            first = first or e
    if first is not None:
        raise first
    return paths


def dense(a):
    """Dense row-major and starting on a 16-byte boundary, as the kernels'
    16-byte asynchronous copies (`csrc/async_copy.cuh`) need; a copy only
    where `a` is not."""
    a = a.contiguous()
    return a.clone() if a.data_ptr() % 16 else a


def ptxas_report(log: str) -> dict:
    """Registers, spills, stack and static shared memory of every kernel in
    an `nvcc -Xptxas -v` log, by (demangled enough) kernel name, type and
    integer template argument if any (`forward_metrics_kernel<double, 4>`)."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function "
                      r"'_Z\d+(\w+?)I([fd])(?:Li(\d+)E)?E", line)
        if m:
            kind = "float" if m.group(2) == "f" else "double"
            arg = "" if m.group(3) is None else f", {m.group(3)}"
            name = f"{m.group(1)}<{kind}{arg}>"
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[name].update(stack_bytes=int(m.group(1)),
                             spill_store_bytes=int(m.group(2)),
                             spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            out[name]["static_smem_bytes"] = int(s.group(1)) if s else 0
    return out
