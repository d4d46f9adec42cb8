"""Build and load the port's CUDA kernels.

`csrc/*.cu` compile with nvcc, one process per source, all started
together, and link into one shared library with a plain C interface under
`build/vid2vid_tpu_torch/` at the root of the checkout; the file name
carries a hash of the sources and flags, so a changed source builds anew
and an unchanged one is reused. The library is
loaded with ctypes. Nothing here runs at import: the build happens at the
first kernel launch (or an explicit `library()` call).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "vid2vid_tpu_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from csrc/ at first use"
    )


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libv2v_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands in parallel and wait for every one; raise on the
    first that failed, with its output. Returns each one's output."""
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cmd in cmds
    ]
    logs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, log in zip(cmds, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    return logs


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu for sm_90a unless the hashed library exists."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build into a temporary directory, then rename: a cut build leaves no
    # half-written library behind under the final name
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        sources = [s for s in _sources() if s.suffix == ".cu"]
        objs = [os.path.join(tmp, f"{src.stem}.o") for src in sources]
        ptxas = ["-Xptxas", "-v"] if verbose else []
        logs = _run_all([
            [nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o", obj, str(src)]
            for src, obj in zip(sources, objs)
        ])
        lib = os.path.join(tmp, out.name)
        logs += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", lib, *objs]])
        if verbose:
            print("".join(logs))
        os.replace(lib, out)
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library, loaded once per process."""
    return ctypes.CDLL(str(build()))


def function(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """A C entry point of the library with its signature declared.

    Every entry returns cudaGetLastError() as an int.
    """
    fn = getattr(library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


# csrc/common.cuh::DType
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def require_cuda_operands(
    what: str, device: torch.device, dtype: torch.dtype, **tensors
) -> int:
    """Validate the operands of a CUDA kernel; return its dtype code.

    Every tensor must lie on `device`, a CUDA device, be contiguous and have
    `dtype`, which must be one the kernels take. Raises ValueError otherwise
    (a wrong device, dtype or layout is never converted behind the caller).
    """
    if device.type != "cuda":
        raise ValueError(f"{what}: device {device} is not CUDA")
    if dtype not in DTYPE_CODES:
        raise ValueError(f"{what}: dtype {dtype} not supported (f32, bf16)")
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, not {device}")
        if t.dtype != dtype:
            raise ValueError(f"{what}: {name} has dtype {t.dtype}, not {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
    return DTYPE_CODES[dtype]
