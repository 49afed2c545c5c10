"""Build the package's CUDA sources with nvcc, and the host sources of
``native/`` with g++/gcc, at first use.

Each ``csrc/<name>.cu`` compiles to ``build/<name>-<hash>.so`` beside the
package (``build/`` is git-ignored), with a plain C interface loaded through
ctypes. ``build_native`` compiles a C or C++ source of the repo's ``native/``
directory the same way (``build/<stem>-<hash>.so``); the port reads the
source there and never builds into or loads from ``native/``. A source may include headers that Python generates; they are written
to ``build/<name>-<hash>/`` and put on the include path. The hash covers the
source, the generated headers and the flags, so an edited source or schedule
never loads a stale library. ptxas's report of registers and spills for each
kernel is kept beside the library. Nothing here runs at import time.

Every op with a hand kernel goes through two functions here. ``plain_or_kernel``
holds the port's device rule: a CPU tensor takes the op's plain PyTorch
version, a CUDA tensor its kernel, any other device raises. ``launch`` is the
one launch of a kernel: on the device's current stream, its return checked,
and counted in the tracer as ``<name>_launches``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from . import tracing

PACKAGE_DIR = Path(__file__).resolve().parent
BUILD_DIR = PACKAGE_DIR.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_FUNCS: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def library_path(name: str, headers: dict[str, str] | None = None) -> Path:
    h = hashlib.sha256((PACKAGE_DIR / "csrc" / f"{name}.cu").read_bytes())
    for fname, text in sorted((headers or {}).items()):
        h.update(f"\0{fname}\0{text}".encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(name: str, headers: dict[str, str] | None = None) -> Path:
    """Compile csrc/<name>.cu with the generated ``headers`` unless the current build exists."""
    out = library_path(name, headers)
    if out.exists():
        return out
    include = out.with_suffix("")
    include.mkdir(parents=True, exist_ok=True)
    for fname, text in (headers or {}).items():
        (include / fname).write_text(text)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(include), "-o", str(tmp), str(PACKAGE_DIR / "csrc" / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}\n{proc.stderr}")
    out.with_suffix(".ptxas.txt").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
    return out


def load(name: str, headers: dict[str, str] | None = None) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu, once per process."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name, headers)))
            _LIBS[name] = lib
        return lib


def function(name: str, symbol: str, argtypes: list, headers=None):
    """The C function ``symbol`` of csrc/<name>.cu, taking ``argtypes`` and
    returning an int (0, a cudaError_t, or a negative code for arguments the
    kernel does not take); built and loaded at first use, then cached.
    ``headers`` is a function giving the generated headers, called only then."""
    with _LOCK:
        fn = _FUNCS.get((name, symbol))
    if fn is None:
        fn = getattr(load(name, headers() if headers else None), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        with _LOCK:
            _FUNCS[(name, symbol)] = fn
    return fn


def check_launch(rc: int, what: str, refused: dict[int, str] | None = None) -> None:
    """Raise for a launcher's nonzero return: ValueError for a negative code
    (arguments the kernel does not take, ``refused`` names them), RuntimeError
    for a cudaError_t."""
    if rc < 0:
        raise ValueError(f"the {what} kernel does not take these arguments: {(refused or {}).get(rc, f'code {rc}')}")
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed (cudaError {rc})")


def launch(name: str, symbol: str, argtypes: list, device: torch.device, *args, refused: dict[int, str] | None = None,
           headers=None) -> None:
    """One launch of ``symbol`` of csrc/<name>.cu (``function``) on ``device``'s
    current stream, which it takes last: a tensor passes as its data pointer,
    anything else as it is. Raises for a nonzero return (``check_launch``) and
    counts ``<name>_launches`` in the tracer."""
    fn = function(name, symbol, argtypes, headers)
    with torch.cuda.device(device):
        rc = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args), torch.cuda.current_stream(device).cuda_stream)
    check_launch(rc, name, refused)
    tracing.count(f"{name}_launches")


def plain_or_kernel(op: str, plain, kernel, *args):
    """``op`` on its first argument's device: ``plain(*args)`` for a CPU
    tensor, ``kernel(*args)`` for a CUDA tensor; ValueError for any other."""
    device = args[0].device
    if device.type == "cpu":
        return plain(*args)
    if device.type == "cuda":
        return kernel(*args)
    raise ValueError(f"{op} runs on cuda or cpu, got {device}")


def build_native(src: Path, compiler: str, flags: tuple[str, ...], libs: tuple[str, ...] = ()) -> Path:
    """Compile the host source ``src`` into a shared library with ``compiler``
    unless the current build exists; the hash covers the source and the
    command line. Raises when the compiler is missing or fails."""
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join((compiler, *flags, *libs)).encode())
    out = BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([compiler, *flags, "-o", str(tmp), str(src), *libs], capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{compiler} failed for {src.name}:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
    return out


def ptxas_usage(name: str, headers: dict[str, str] | None = None) -> dict[str, dict[str, int]]:
    """Registers and spill bytes of each kernel of the built csrc/<name>.cu, by demangled name."""
    report = library_path(name, headers).with_suffix(".ptxas.txt").read_text()
    usage: dict[str, dict[str, int]] = {}
    kernel = None
    for line in report.splitlines():
        if m := re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)'?", line):
            kernel = m.group(1)
            usage.setdefault(kernel, {})
        elif kernel and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            usage[kernel].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif kernel and (m := re.search(r"Used (\d+) registers", line)):
            usage[kernel]["registers"] = int(m.group(1))
    names = list(usage)
    filt = shutil.which("c++filt")
    if filt and names:
        demangled = subprocess.run([filt], input="\n".join(names), capture_output=True, text=True, check=True).stdout.split("\n")
        return {d.replace("(anonymous namespace)::", ""): usage[n] for n, d in zip(names, demangled)}
    return usage
