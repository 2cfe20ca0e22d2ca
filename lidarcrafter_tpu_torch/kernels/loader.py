"""Build, load and self-check the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  The build
runs at first use, one ``nvcc`` per source, all started together, into
``lidarcrafter_tpu_torch/build/`` (listed in ``.gitignore``); a library is
named after a hash of its sources and flags, so a changed source rebuilds.
The Hopper core (``csrc/hopper_flash.cuh``) builds its TMA tensor maps on
the host per call with libcuda's ``cuTensorMapEncodeTiled``, reached through
the runtime's entry-point query, so no library links ``libcuda`` and the
``nvcc`` line is the same for every source.

After loading, the trivial ``probe_x2`` kernel runs once on the card and the
loader raises if it fails or disagrees.  This replaces the JAX package's
Mosaic probe (``ops/mosaic.py``), except that there is no route to fall back
to: a kernel that does not build or launch is an error.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch
from torch.autograd import forward_ad

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
SOURCES = ("probe", "groupnorm", "oaca", "attention")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class OacaArgs(ctypes.Structure):
    """Mirror of ``struct OacaArgs`` in ``csrc/oaca.cu`` (all fields 8 bytes)."""

    _fields_ = [
        ("qc", ctypes.c_void_p), ("ipe", ctypes.c_void_p), ("kc", ctypes.c_void_p),
        ("kl", ctypes.c_void_p), ("vc", ctypes.c_void_p), ("vl", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("qc_s", ctypes.c_int64 * 3), ("ipe_s", ctypes.c_int64 * 3),
        ("kc_s", ctypes.c_int64 * 3), ("kl_s", ctypes.c_int64 * 3),
        ("vc_s", ctypes.c_int64 * 3), ("vl_s", ctypes.c_int64 * 3),
        ("out_s", ctypes.c_int64 * 3),
        ("B", ctypes.c_int64), ("H", ctypes.c_int64),
        ("Lq", ctypes.c_int64), ("L2", ctypes.c_int64),
        ("scale2", ctypes.c_double),
        ("ipe_k", ctypes.c_void_p), ("ipe_k_s", ctypes.c_int64 * 3), ("Lk", ctypes.c_int64),
    ]


class AttnArgs(ctypes.Structure):
    """Mirror of ``struct AttnArgs`` in ``csrc/attention.cu`` (all fields 8 bytes)."""

    _fields_ = [
        ("q", ctypes.c_void_p), ("k", ctypes.c_void_p), ("v", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("q_s", ctypes.c_int64 * 3), ("k_s", ctypes.c_int64 * 3),
        ("v_s", ctypes.c_int64 * 3), ("out_s", ctypes.c_int64 * 3),
        ("B", ctypes.c_int64), ("H", ctypes.c_int64), ("Lq", ctypes.c_int64),
        ("Lkv", ctypes.c_int64), ("kv_len", ctypes.c_int64),
        ("dqk", ctypes.c_int64), ("dv", ctypes.c_int64),
        ("scale", ctypes.c_double),
    ]


class GnArgs(ctypes.Structure):
    """Mirror of ``struct GnArgs`` in ``csrc/groupnorm.cu`` (all fields 8 bytes)."""

    _fields_ = [
        ("x", ctypes.c_void_p), ("y", ctypes.c_void_p),
        ("w", ctypes.c_void_p), ("b", ctypes.c_void_p),
        ("s", ctypes.c_void_p), ("t", ctypes.c_void_p),
        ("w_bs", ctypes.c_int64), ("b_bs", ctypes.c_int64),
        ("s_bs", ctypes.c_int64), ("t_bs", ctypes.c_int64),
        ("w_dt", ctypes.c_int64), ("b_dt", ctypes.c_int64),
        ("s_dt", ctypes.c_int64), ("t_dt", ctypes.c_int64),
        ("work", ctypes.c_void_p),
        ("dtype", ctypes.c_int64), ("B", ctypes.c_int64), ("HW", ctypes.c_int64),
        ("C", ctypes.c_int64), ("G", ctypes.c_int64),
        ("k", ctypes.c_int64), ("rows_par", ctypes.c_int64),
        ("stage_rows", ctypes.c_int64), ("silu", ctypes.c_int64),
        ("eps", ctypes.c_double),
        ("stats", ctypes.c_void_p), ("n_parts", ctypes.c_int64),
    ]


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "probe": {"probe_x2": [_P, _P, _I, _P]},
    "groupnorm": {"gn_forward": [GnArgs, _P], "gn_partials": [GnArgs, _P], "gn_apply": [GnArgs, _P]},
    "oaca": {"oaca_forward": [OacaArgs, _I, _I, _I, _I, _P], "oaca_forward_on": [OacaArgs, _I, _I, _I, _I, _I, _P],
             "oaca_plan": [_I, _I, _I, _I, ctypes.POINTER(ctypes.c_int32)]},
    "attention": {"attention_forward": [AttnArgs, _I, _P], "attention_forward_on": [AttnArgs, _I, _I, _P],
                  "attention_plan": [_I, _I, _I, ctypes.POINTER(ctypes.c_int32)]},
}

# csrc/hopper_flash.cuh: the warp-specialised TMA + wgmma core's shared-memory plan
SMEM_LIMIT = 232448  # dynamic shared memory a block may use on sm_90 (227 KB)
SMEM_LIMIT2 = 115712  # each of two blocks an SM (228 KB, 1 KB of it reserved a block)
_ALIGN, _MAX_STAGES, _ROWS = 1024, 4, 64
CHUNK, HALF = 128, 64  # bytes of a wide (128B-swizzled) and a narrow (64B-swizzled) chunk's row
# the routes of attention and OACA by operand type: the Hopper core, and the
# cp.async + mma.sync loader (csrc/flash_mma.cuh) that keeps float32 at the
# narrow head dims
CORE_ROUTES = {torch.float32: "tma mma 3xTF32", torch.bfloat16: "wgmma bf16"}
MMA_ROUTES = {torch.float32: "mma 3xTF32", torch.bfloat16: "mma bf16"}


@dataclasses.dataclass(frozen=True)
class HopperLayout:
    """Mirror of ``hflash::plan_layout``: the shared memory of one block of
    the Hopper core (q tiles, a ring of ``stages`` K/V stages, the split
    route's score exchange, the barriers); ``stages`` 0 when none fits."""

    stages: int
    smem: int


def hopper_layout(split: bool, bk: int, qk_row: int, v_row: int, out_bytes: int, blocks: int = 1) -> HopperLayout:
    """The plan for key tiles of ``bk`` rows, q / k rows of ``qk_row`` bytes
    in shared memory (128-byte chunks, then 64-byte ones) and V rows of
    ``v_row``, one consumer's 64 query rows (split) or both consumers' 128;
    the block's output, ``out_bytes`` staged at the end, must fit below the
    barriers; ``blocks`` 2 halves the shared memory (two blocks an SM)."""
    q_bytes = _ROWS * qk_row * (1 if split else 2)
    stage = bk * (qk_row + v_row)
    x_bytes = 2 * 2 * 128 * (bk // 2) * 4 if split else 0
    bars = 8 * (4 * _MAX_STAGES + 1)  # K and V full / empty rings, the q barrier
    room = (SMEM_LIMIT if blocks == 1 else SMEM_LIMIT2) - _ALIGN - q_bytes - x_bytes - bars
    stages = 0 if room < stage else min(room // stage, _MAX_STAGES)
    bar = q_bytes + stages * stage + x_bytes
    return HopperLayout(stages if bar >= out_bytes else 0, bar + bars + _ALIGN)


@dataclasses.dataclass
class LaunchCounter:
    """Launches a kernel wrapper has made since the caller last reset ``n``."""

    name: str
    n: int = 0


@dataclasses.dataclass
class Kernels:
    libs: dict[str, ctypes.CDLL]
    build_seconds: float  # wall time of the parallel nvcc step (0 if cached)
    ptxas_log: str  # nvcc -Xptxas -v output of the sources built this call


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cuh")) + [CSRC_DIR / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _build(names: list[str]) -> tuple[float, str]:
    """Compile ``names`` in parallel; raise with nvcc's output on failure."""
    if not names:
        return 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        out = _lib_path(name)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    logs, failed = [], []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs.append(f"== {name}.cu ==\n{log}")
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)
    seconds = time.perf_counter() - t0
    log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
    return seconds, log


probe_launches = LaunchCounter("probe")


def _probe(lib: ctypes.CDLL) -> None:
    x = torch.arange(8 * 128, dtype=torch.float32, device="cuda").reshape(8, 128)
    y = torch.empty_like(x)
    probe_launches.n += 1
    err = lib.probe_x2(x.data_ptr(), y.data_ptr(), x.numel(),
                       torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"probe_x2 launch failed: cudaError {err}")
    torch.cuda.synchronize()
    if not torch.equal(y, x * 2):
        raise RuntimeError("probe_x2 kernel returned wrong values")


_LOCK = threading.Lock()


@functools.cache
def load_kernels() -> Kernels:
    """Build (if needed), load and self-check every kernel; cached per process."""
    with _LOCK:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA kernels requested but no CUDA device is available")
        todo = [n for n in SOURCES if not _lib_path(n).exists()]
        seconds, log = _build(todo)
        libs = {}
        for name in SOURCES:
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn_name, argtypes in _SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            libs[name] = lib
        _probe(libs["probe"])
        return Kernels(libs=libs, build_seconds=seconds, ptxas_log=log)


def library(name: str) -> ctypes.CDLL:
    return load_kernels().libs[name]


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def has_tangent(*ops: torch.Tensor | None) -> bool:
    """Whether an operand carries a forward-mode tangent: a tensor wrapped
    by a ``torch.func`` transform (``jvp``, or any other) or a
    ``forward_ad`` dual.  Such an operand has no storage of its own to hand
    a kernel, and a launch on its primal would drop the tangent."""
    return any(
        t is not None and (torch._C._functorch.is_functorch_wrapped_tensor(t)
                           or forward_ad.unpack_dual(t).tangent is not None)
        for t in ops
    )


def tracing() -> bool:
    """Whether ``torch.export`` (or ``torch.compile``) is tracing the
    caller: the wrappers then call their operators, which the graph
    records, and otherwise launch or run the plain version directly, with
    no dispatcher on an eager call."""
    return torch.compiler.is_compiling()


def tma_addressable(t: torch.Tensor) -> bool:
    """Whether a TMA tensor map (``hflash::make_map``, a box of a 128- or
    64-byte chunk in the swizzle of that width: the same limits) can address
    a (B, heads, rows, d) operand: int32 row coordinates, and strides below
    2^40 bytes on its batch, head and row dims of more than one element
    (``make_map`` gives a size-1 dim a stride of its own).  The box may
    reach past d (zero-filled); whole 16-byte strides are
    ``check_aligned``'s to refuse."""
    return t.shape[2] < 2**31 and all(
        n == 1 or abs(st) * t.element_size() < 2**40 for n, st in zip(t.shape[:3], t.stride()[:3]))


def check_aligned(what: str, *ops: torch.Tensor) -> None:
    """Raise ``ValueError`` unless every operand's pointer, (batch, head,
    row) strides and head dim are whole multiples of 16 bytes: the kernels
    copy rows to shared memory in 16-byte ``cp.async`` pieces.  The
    operands must be plain tensors (no tangent): the check reads pointers."""
    for t in ops:
        elt = t.element_size()
        if t.data_ptr() % 16 or any(n * elt % 16 for n in (*t.stride()[:3], t.shape[-1])):
            raise ValueError(
                f"{what} kernel needs 16-byte aligned operands: pointer, (batch, head, row) "
                f"strides and head dim in whole 16-byte pieces; got strides {tuple(t.stride())}, "
                f"shape {tuple(t.shape)}, {elt}-byte elements, pointer {t.data_ptr():#x}"
            )
