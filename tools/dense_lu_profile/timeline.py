"""Where the dense-LU kernel (K2/K3, ``src/repro_torch/kernels/csrc/
dense_lu.cuh``) spends a phase, on one NVIDIA GPU.

    python3 tools/dense_lu_profile/timeline.py

The profiler sees the kernel as one launch; this tool looks inside it.  It
compiles a copy of the header with ``%globaltimer`` stamps at eight points
of a phase (written by thread 0 of every CTA into a buffer given through a
device symbol), runs K2 at N = 160 and 736 (float64 and float32) and K3 at
N = 736 (complex128 planes), and prints, for some phases and averaged over
all, the panel CTAs' time from the phase start to their operands landing
(load), their two block products (gemms), the panel factor (factor) and the
store, the trailing CTAs' time, and the grid barrier from the last CTA's
arrival to the release.  It also builds ``pieces.cu`` beside it, which
times the kernel's parts in one CTA with ``clock64``: each kind of panel
factor, one block product, 32 named barriers.

The stamps change the code a little (registers, scheduling), so read the
phases' shares, not their sum, and time the kernel itself with
``chip_smoke.py``.  Builds go to ``build/dense_lu_profile/``.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.kernels import _build  # noqa: E402

HEADER = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "dense_lu.cuh"
OUT = ROOT / "build" / "dense_lu_profile"
N_STAMPS = 8

# (text in dense_lu_kernel, stamp, before or after it)
HOOKS = [
    ("const int Tn = s >= 1 ? m * m : 0;", 0, "before"),
    ("        issue_operands<Ops>(src, out, N, bi, bj, s, stage1);\n"
     "        cp_async_wait<0>();\n        __syncthreads();", 1, "after"),
    ("        block_to_shared<Ops>(stage1, s, st);\n        __syncthreads();",
     2, "after"),
    ("          panel_factor<Ops, 2>(sd, st, smul);\n        __syncthreads();",
     3, "after"),
    ("        block_store<Ops>(st, out, N, bi, bj);\n        __syncthreads();",
     4, "after"),
    ("    // trailing blocks, the next one's operands in flight", 5, "before"),
    ("    if (s < nb - 1) grid.sync();", 6, "before"),
    ("    if (s < nb - 1) grid.sync();", 7, "after"),
]

STAMP = r'''
__device__ unsigned long long* g_stamps = nullptr;
__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
#define STAMP(k)                                                              \
  do {                                                                        \
    if (threadIdx.x == 0 && g_stamps)                                         \
      g_stamps[((unsigned long long)blockIdx.x * (N / kB) + s) * 8 + (k)] =   \
          now_ns();                                                           \
  } while (0)
'''

ENTRIES = r'''
#include "dense_lu.cuh"
extern "C" int set_stamps(void* p) { return cudaMemcpyToSymbol(g_stamps, &p, sizeof(p)); }
extern "C" int lu_f64(const void* a, void* o, int N, void* s) { return dense_lu<RealOps<double>>(a, o, N, s); }
extern "C" int lu_f32(const void* a, void* o, int N, void* s) { return dense_lu<RealOps<float>>(a, o, N, s); }
extern "C" int lu_c128(const void* a, void* o, int N, void* s) { return dense_lu<PlanarOps<double>>(a, o, N, s); }
'''


def nvcc(*args):
    cmd = [_build.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", *args]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"{' '.join(cmd)}\n{r.stdout}\n{r.stderr}")


def build_stamped():
    text = HEADER.read_text().replace(
        "namespace cg = cooperative_groups;",
        "namespace cg = cooperative_groups;\n" + STAMP)
    for needle, k, where in HOOKS:
        assert needle in text, f"hook {k} not found: the kernel changed"
        text = text.replace(
            needle, f"{needle} STAMP({k});" if where == "after"
            else f"STAMP({k}); {needle}", 1)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "dense_lu.cuh").write_text(text)
    (OUT / "stamped.cu").write_text(ENTRIES)
    so = OUT / "libstamped.so"
    nvcc("-Xcompiler", "-fPIC", "-shared", "-o", str(so), str(OUT / "stamped.cu"))
    lib = ctypes.CDLL(str(so))
    for name in ("lu_f64", "lu_f32", "lu_c128"):
        getattr(lib, name).argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int,
                                                              ctypes.c_void_p]
    lib.set_stamps.argtypes = [ctypes.c_void_p]
    return lib


def mean_us(rows, i, j):
    d = [r[j] - r[i] for r in rows if r[i] > 0 and r[j] > 0]
    return float(np.mean(d)) / 1e3 if d else float("nan")


def timeline(lib, entry, N, planar, dtype):
    rng = np.random.default_rng(0)
    a = rng.normal(size=(2, N, N) if planar else (N, N))
    (a[0] if planar else a)[...] += N * np.eye(N)
    a = torch.from_numpy(a).to("cuda", dtype)
    out = torch.empty_like(a)
    nb = N // 32
    stamps = torch.zeros(1024 * nb * N_STAMPS, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    fn = getattr(lib, entry)
    for _ in range(3):
        assert fn(a.data_ptr(), out.data_ptr(), N, stream) == 0
    torch.cuda.synchronize()
    assert lib.set_stamps(stamps.data_ptr()) == 0
    assert fn(a.data_ptr(), out.data_ptr(), N, stream) == 0
    torch.cuda.synchronize()
    assert lib.set_stamps(None) == 0
    t = stamps.view(1024, nb, N_STAMPS).cpu().numpy()
    grid = int((t[:, 0, 0] > 0).sum())
    t = t[:grid]
    t0 = t[t > 0].min()
    print(f"== {entry} N={N} grid={grid} CTAs, stamped run "
          f"{(t.max() - t0) / 1e3:.1f} us")
    cols = ("load", "gemms", "factor", "store", "trailing", "barrier")
    sums = {c: [] for c in cols}
    for s in range(nb):
        ph = t[:, s, :]
        panel = ph[ph[:, 1] > 0]
        trail = ph[(ph[:, 1] == 0) & (ph[:, 6] > 0)]
        arrive, release = ph[:, 6][ph[:, 6] > 0], ph[:, 7][ph[:, 7] > 0]
        row = dict(load=mean_us(panel, 0, 1), gemms=mean_us(panel, 1, 2),
                   factor=mean_us(panel, 2, 3), store=mean_us(panel, 3, 4),
                   trailing=mean_us(trail, 0, 6),
                   barrier=(release.max() - arrive.max()) / 1e3
                   if len(release) else float("nan"))
        for c in cols:
            if not np.isnan(row[c]):
                sums[c].append(row[c])
        if s in (1, nb // 2, nb - 2):
            print(f"  phase {s:2d}: " + ", ".join(
                f"{c} {row[c]:.2f}" for c in cols) + " us")
    print("  mean over phases: " + ", ".join(
        f"{c} {np.mean(v):.2f}" for c, v in sums.items() if v) + " us")


def main():
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    print(torch.cuda.get_device_name(0), subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    OUT.mkdir(parents=True, exist_ok=True)
    pieces = OUT / "pieces"
    nvcc("-I", str(HEADER.parent), "-o", str(pieces),
         str(Path(__file__).with_name("pieces.cu")))
    print(subprocess.run([str(pieces)], capture_output=True, text=True,
                         check=True).stdout, end="")
    lib = build_stamped()
    for entry, N, planar, dtype in (("lu_f64", 160, False, torch.float64),
                                    ("lu_f64", 736, False, torch.float64),
                                    ("lu_f32", 736, False, torch.float32),
                                    ("lu_c128", 736, True, torch.float64)):
        timeline(lib, entry, N, planar, dtype)
    return 0


if __name__ == "__main__":
    sys.exit(main())
