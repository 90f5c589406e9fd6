"""Build the port's CUDA kernels with nvcc and load them with ctypes.

At first use, every ``src/repro_torch/csrc/*.cu`` is compiled for Hopper
(``sm_90a``) into an object file -- one ``nvcc`` per source, all started
together -- and the objects are linked into ONE shared library under
``build/repro_torch/`` at the repository root, keyed by a hash of the
sources and flags, so an unchanged tree reuses it.  The library exposes
a plain C interface: pointers and the stream are ``ctypes.c_void_p``,
ints ``c_int``, scalars ``c_float``, and every entry point returns
``cudaGetLastError()`` after its launch.

No PyTorch header is compiled (a source that includes them takes
minutes to build), and nothing here runs at import time: the CPU tests
import every module on a machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
ROOT = pathlib.Path(__file__).resolve().parents[3]
BUILD_DIR = ROOT / "build" / "repro_torch"

# -fmad=false on top of the __fmul_rn/__fadd_rn intrinsics: no multiply
# and add anywhere in the kernels may contract into an FMA.  -Xptxas -v
# reports each kernel's registers, shared memory and spills; the report
# is kept beside the library (ptxas_report).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# entry point -> argtypes (restype is c_int for all of them)
SIGNATURES = {
    "repro_sign_pack_f32": (_P, _P, _F, _P, _I, _I, _I, _P),
    "repro_sign_pack_bf16": (_P, _P, _F, _P, _I, _I, _I, _P),
    "repro_vote_update": (_P, _P, _I, _P, _P, _F, _I, _I, _I, _P),
    "repro_tally_acc": (_P, _P, _F, _P, _P, _I, _I, _I, _I, _I, _P),
    "repro_ternary_quant": (_P, _P, _P, _P, _I, _I, _I, _P),
}

_lib: ctypes.CDLL | None = None


def find_nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then ``PATH``, then
    ``/usr/local/cuda/bin/nvcc``; raises when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the repro_torch CUDA kernels cannot be "
        "built on this machine")


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(list(srcs) + sorted(CSRC.glob("*.cuh"))):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile the kernels (if the hashed library is missing) and return
    the path of the shared library.  One ``nvcc -c`` per source runs at
    once, so the build takes as long as its slowest source."""
    srcs = sources()
    lib_path = BUILD_DIR / f"librepro_torch_{_digest(srcs)}.so"
    if lib_path.exists():
        return lib_path
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [pathlib.Path(tmp) / (src.stem + ".o") for src in srcs]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(srcs, objs)]
        outs = [proc.communicate()[0] for proc in procs]
        failed = [f"--- {src.name}\n{out}" for src, proc, out
                  in zip(srcs, procs, outs) if proc.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = pathlib.Path(tmp) / lib_path.name
        subprocess.run([nvcc, "-shared", "-o", str(tmp_lib), *map(str, objs)],
                       check=True)
        tmp_log = pathlib.Path(tmp) / "ptxas.txt"
        tmp_log.write_text("".join(f"--- {src.name}\n{out}"
                                   for src, out in zip(srcs, outs)))
        os.replace(tmp_log, _report_path(lib_path))
        os.replace(tmp_lib, lib_path)    # atomic: concurrent builders agree
    return lib_path


def _report_path(lib_path: pathlib.Path) -> pathlib.Path:
    return lib_path.with_suffix(".ptxas.txt")


def ptxas_report() -> str:
    """What ``nvcc -Xptxas -v`` printed for each source when the current
    library was built (builds it first if needed)."""
    return _report_path(build()).read_text()


def load() -> ctypes.CDLL:
    """The kernel library, built and loaded once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


ALIGN = 16      # bytes: the address granularity of a bulk async copy


def require_aligned(kernel: str, **tensors) -> None:
    """Raise ``ValueError`` for a tensor (``None`` is skipped) whose first
    byte is not ``ALIGN``-byte aligned: the kernels read it by bulk async
    copies, which need 16-byte addresses."""
    for name, t in tensors.items():
        if t is not None and t.data_ptr() % ALIGN:
            raise ValueError(
                f"{kernel}: {name} must start on a {ALIGN}-byte boundary "
                f"(address {t.data_ptr():#x}): the kernel reads it by bulk "
                f"async copies")


def check(status: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` from an entry point."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {status}")
